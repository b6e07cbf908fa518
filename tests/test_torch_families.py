"""The port's five other transformer families (MoE + MLA, SSM, hybrid,
audio codebooks, VLM patches) against the JAX package's, on the CPU, where
the decode-attention wrapper runs its kernel's plain version (with every
check it makes on the card).

Weights are the JAX ``init_params``/``*_init``, carried over with
``transformer_params_from_jax`` (or as numpy dicts for a module); inputs
come from numpy seeds. Tolerances, all float32:

* modules (``moe_apply`` and its aux, the SSD's decode step and final
  state, ``mla_apply``, ``block_apply``): rtol/atol 1e-5;
* the SSD's chunked pass and a block that runs it: rtol/atol 1e-4 (the
  chunked exponentials, exp(cum_i - cum_j) over a chunk, summed in another
  order than XLA's);
* whole models (prefill, then 8 decode steps): rtol/atol 1e-4 on every
  step's logits, and the greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import list_archs as j_list_archs
from repro.models.transformer import blocks as jb
from repro.models.transformer import model as jm
from repro.models.transformer import moe as jmoe
from repro.models.transformer import ssm as jssm
from repro.models.transformer.config import ArchConfig as JArchConfig
from repro_torch import serve
from repro_torch.configs import get_arch, list_archs
from repro_torch.kernels.flash_decode import kernel as fd_kernel
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models.transformer import blocks as tb
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer import moe as tmoe
from repro_torch.models.transformer import ssm as tssm
from repro_torch.models.transformer.config import ArchConfig

MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
SSD_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
#: the five families' configs (two for MoE + MLA: without and with q_lora)
FAMILIES = ["deepseek-v2-lite-16b", "deepseek-v2-236b", "mamba2-2.7b",
            "hymba-1.5b", "musicgen-medium", "llava-next-mistral-7b"]


def _np(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _torch_tree(tree):
    """A JAX pytree of dicts as torch tensors (numpy in between)."""
    return jax.tree_util.tree_map(lambda a: _t(np.array(a)), tree)


def _both(jcfg):
    """The port's ``ArchConfig`` with the values of a JAX one."""
    return ArchConfig(**dataclasses.asdict(jcfg))


def _serve_cfgs(name):
    full = j_get_arch(name)
    jcfg = full.reduced(attn_window=16 if full.attn_window else None)
    return jcfg, serve.serve_config(name, reduced=True)


def _model(jcfg, cfg, seed=0):
    params = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return params, np_params, tm.transformer_params_from_jax(np_params, cfg, "cpu")


def _jax_embed(dst, src):
    """``examples/serve_transformer.py``'s copy of the prefill caches into
    the decode-length caches."""
    if dst.shape == src.shape:
        return src.astype(dst.dtype)
    axis = [i for i, (a, b) in enumerate(zip(dst.shape, src.shape)) if a != b][0]
    return jax.lax.dynamic_update_slice_in_dim(dst, src.astype(dst.dtype), 0,
                                               axis=axis)


def _layer_cache(j_caches, jcfg, i):
    """Layer ``i``'s cache out of the JAX ``{"scan", "lead"}`` layout."""
    n_lead = jcfg.first_dense_layers if jcfg.family == "moe" else 0
    if i < n_lead:
        return j_caches["lead"][i]
    return jax.tree_util.tree_map(lambda a: a[i - n_lead], j_caches["scan"])


def _assert_tree_close(got, want, tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_close(got[k], want[k], tol)
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# --------------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------------- #
def test_all_ten_configs_are_registered():
    assert list_archs() == j_list_archs()
    assert len(list_archs()) == 10


@pytest.mark.parametrize("name", j_list_archs())
def test_config_and_counts_equal_the_reference(name):
    cfg, jcfg = get_arch(name), j_get_arch(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(jcfg.reduced())
    for c, j in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
        assert c.param_count() == j.param_count()
        assert c.active_param_count() == j.active_param_count()
    # the port's init makes the reference init's leaves: shapes and dtypes
    model = tm.init_params(cfg.reduced(), torch.Generator().manual_seed(0))
    want = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0),
                                                 jcfg.reduced()))
    n_lead = len(model.lead_blocks)
    leaves = [(tuple(a.shape[1:]) if "'blocks'" in jax.tree_util.keystr(k)
               else tuple(a.shape), str(a.dtype))
              for k, a in jax.tree_util.tree_leaves_with_path(want)
              for _ in range(a.shape[0] if "'blocks'" in jax.tree_util.keystr(k)
                             else 1)]
    got = [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for t in model.parameters()]
    assert sorted(got) == sorted(leaves)
    assert n_lead == (jcfg.first_dense_layers if jcfg.family == "moe" else 0)


# --------------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------------- #
def _moe_cfg(mlp_type, cf, shared=1):
    return JArchConfig(
        name="t", family="moe", num_layers=1, d_model=32, vocab_size=64,
        num_experts=4, moe_top_k=2, moe_d_ff=16, num_shared_experts=shared,
        moe_capacity_factor=cf, mlp_type=mlp_type, dtype="float32")


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "mlp"])
@pytest.mark.parametrize("cf", [1.0, 8.0])
def test_moe_apply_matches_jax(mlp_type, cf):
    """Output and aux at a capacity that drops tokens (1.0: the same set
    dropped, or the outputs would differ) and at one that drops none."""
    jcfg = _moe_cfg(mlp_type, cf, shared=1 if mlp_type == "swiglu" else 0)
    params = jmoe.moe_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    x = _np(np.random.default_rng(4), 2, 24, 32)
    want, want_aux = jmoe.moe_apply(params, jnp.asarray(x), jcfg)
    got, aux = tmoe.moe_apply(_torch_tree(params), _t(x), _both(jcfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **MODULE_TOL)
    # how many (token, expert) picks the capacity dropped
    gates = jax.nn.softmax(jnp.asarray(x).reshape(-1, 32) @ params["router"], -1)
    load = np.bincount(np.asarray(jax.lax.top_k(gates, 2)[1]).ravel(), minlength=4)
    C = tmoe.moe_capacity(_both(jcfg), 48)
    dropped = int(np.maximum(load - C, 0).sum())
    assert (dropped > 0) == (cf == 1.0), (load, C)


def test_moe_combine_sums_each_token_in_expert_order():
    """The fixed-order combine equals a dense top-k sum at ample capacity,
    and repeats bit for bit."""
    jcfg = _moe_cfg("swiglu", 8.0, shared=0)
    cfg = _both(jcfg)
    p = _torch_tree(jmoe.moe_init(jax.random.PRNGKey(5), jcfg, jnp.float32))
    x = _t(_np(np.random.default_rng(6), 3, 5, 32))
    out, _ = tmoe.moe_apply(p, x, cfg)
    again, _ = tmoe.moe_apply(p, x, cfg)
    assert torch.equal(out, again)
    xt = x.reshape(-1, 32)
    gates = torch.softmax(xt @ p["router"], -1)
    topw, tope = torch.topk(gates, 2, -1)
    topw = topw / topw.sum(-1, keepdim=True)
    ref = torch.zeros_like(xt)
    for e in range(4):
        ye = (torch.nn.functional.silu(xt @ p["w_gate"][e]) * (xt @ p["w_in"][e])) \
            @ p["w_out"][e]
        ref = ref + ye * torch.where(tope == e, topw, 0.0).sum(-1)[:, None]
    torch.testing.assert_close(out.reshape(-1, 32), ref, **MODULE_TOL)


def test_moe_shard_map_raises():
    """``opt_moe_shard_map`` selects the expert-local dispatch, which needs a
    model axis: without a mesh the steps and ``moe_apply`` raise; with one
    (an abstract (1, 1) mesh here) the steps build, and the weights need
    none."""
    cfg = dataclasses.replace(get_arch("deepseek-v2-lite-16b").reduced(),
                              opt_moe_shard_map=True)
    for build in (lambda: tm.make_decode_step(cfg),
                  lambda: tm.make_prefill_step(cfg),
                  lambda: tmoe.moe_apply({}, torch.zeros(1, 1, cfg.d_model), cfg)):
        with pytest.raises(ValueError, match="opt_moe_shard_map"):
            build()
    mesh = abstract_mesh((1, 1))
    tm.make_decode_step(cfg, mesh)
    tm.make_prefill_step(cfg, mesh)
    tm.init_params(cfg, torch.Generator().manual_seed(0))


# --------------------------------------------------------------------------- #
# SSM
# --------------------------------------------------------------------------- #
SSM_CFGS = {
    # tests/test_transformer_correctness.py's, one group
    "small": JArchConfig(name="t", family="ssm", num_layers=1, d_model=32,
                         vocab_size=64, ssm_state=8, ssm_expand=2,
                         ssm_headdim=16, ssm_chunk=4, ssm_ngroups=1),
    "groups": JArchConfig(name="t", family="ssm", num_layers=1, d_model=32,
                          vocab_size=64, ssm_state=8, ssm_expand=2,
                          ssm_headdim=8, ssm_chunk=8, ssm_ngroups=2),
    "mamba2": j_get_arch("mamba2-2.7b").reduced(),
    "hymba": j_get_arch("hymba-1.5b").reduced(),
}


def _ssm(name):
    jcfg = SSM_CFGS[name]
    params = jssm.ssm_init(jax.random.PRNGKey(7), jcfg, jnp.float32)
    return jcfg, _both(jcfg), params, _torch_tree(params)


@pytest.mark.parametrize("name", list(SSM_CFGS))
def test_ssm_init_draws_the_reference_a_log_and_dt_bias(name):
    jcfg, cfg, params, _ = _ssm(name)
    got = tssm.ssm_init(torch.Generator().manual_seed(123), cfg, torch.float32)
    for n in ("A_log", "dt_bias", "D", "norm_scale"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(params[n]))
    assert {n: tuple(t.shape) for n, t in got.items()} == {
        n: a.shape for n, a in params.items()}


@pytest.mark.parametrize("name", list(SSM_CFGS))
def test_ssm_apply_train_matches_jax(name):
    jcfg, cfg, params, tparams = _ssm(name)
    x = _np(np.random.default_rng(8), 2, 4 * jcfg.ssm_chunk, jcfg.d_model, scale=0.5)
    want = jssm.ssm_apply_train(params, jnp.asarray(x), jcfg)
    got = tssm.ssm_apply_train(tparams, _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SSD_TOL)
    with pytest.raises(ValueError, match="chunk"):
        tssm.ssm_apply_train(tparams, _t(x[:, 1:]), cfg)


@pytest.mark.parametrize("name", list(SSM_CFGS))
def test_ssm_apply_decode_matches_jax(name):
    jcfg, cfg, params, tparams = _ssm(name)
    rng = np.random.default_rng(9)
    state = _np(rng, 2, jcfg.ssm_nheads, jcfg.ssm_state, jcfg.ssm_headdim, scale=0.3)
    x = _np(rng, 2, 1, jcfg.d_model)
    want, want_state = jssm.ssm_apply_decode(params, jnp.asarray(x),
                                             jnp.asarray(state), jcfg)
    t_state = _t(state).clone()
    got, got_state = tssm.ssm_apply_decode(tparams, _t(x), t_state, cfg)
    assert got_state is t_state  # updated in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)
    np.testing.assert_allclose(got_state.numpy(), np.asarray(want_state),
                               **MODULE_TOL)


@pytest.mark.parametrize("name", list(SSM_CFGS))
def test_ssd_final_state_matches_jax_and_the_recurrence(name):
    jcfg, cfg, params, tparams = _ssm(name)
    x = _np(np.random.default_rng(10), 2, 2 * jcfg.ssm_chunk, jcfg.d_model,
            scale=0.5)
    want = jb._ssd_final_state(params, jnp.asarray(x), jcfg)
    got = tb._ssd_final_state(tparams, _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)
    # the state the port's decode steps reach token by token
    state = torch.zeros_like(got)
    for t in range(x.shape[1]):
        tssm.ssm_apply_decode(tparams, _t(x[:, t:t + 1]), state, cfg)
    torch.testing.assert_close(state, got, **SSD_TOL)


# --------------------------------------------------------------------------- #
# MLA
# --------------------------------------------------------------------------- #
def _mla(q_lora, absorb=False):
    name = "deepseek-v2-236b" if q_lora else "deepseek-v2-lite-16b"
    jcfg = j_get_arch(name).reduced(opt_mla_absorb=absorb)
    assert bool(jcfg.q_lora_rank) == q_lora
    params = jb.attn_init(jax.random.PRNGKey(11), jcfg, jnp.float32)
    return jcfg, _both(jcfg), params, _torch_tree(params)


@pytest.mark.parametrize("q_lora", [False, True])
def test_mla_prefill_matches_jax(q_lora):
    jcfg, cfg, params, tparams = _mla(q_lora)
    x = _np(np.random.default_rng(12), 2, 12, jcfg.d_model)
    want, want_cache = jb.mla_apply(params, jnp.asarray(x), jcfg, mode="prefill")
    got, cache = tb.mla_apply(tparams, _t(x), cfg, mode="prefill")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)
    _assert_tree_close(cache, want_cache, MODULE_TOL)


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("q_lora", [False, True])
@pytest.mark.parametrize("pos", [7, 15])  # inside the cache, and wrapped
def test_mla_decode_matches_jax(q_lora, absorb, pos):
    jcfg, cfg, params, tparams = _mla(q_lora, absorb)
    rng = np.random.default_rng(13 + pos)
    S = 12
    cache = {"c_kv": _np(rng, 2, S, jcfg.kv_lora_rank),
             "k_rope": _np(rng, 2, S, jcfg.qk_rope_dim)}
    x = _np(rng, 2, 1, jcfg.d_model)
    want, want_cache = jb.mla_apply(
        params, jnp.asarray(x), jcfg, mode="decode",
        cache={k: jnp.asarray(v) for k, v in cache.items()}, pos=jnp.int32(pos))
    t_cache = {k: _t(v).clone() for k, v in cache.items()}
    fd_kernel.reset_launches()
    got, got_cache = tb.mla_apply(tparams, _t(x), cfg, mode="decode",
                                  cache=t_cache, pos=torch.tensor(pos))
    assert got_cache is t_cache  # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)
    _assert_tree_close(got_cache, want_cache, MODULE_TOL)
    assert fd_kernel.LAUNCHES["flash_decode"] == 0  # the CPU runs the plain body


def test_mla_decode_passes_the_decode_wrapper_checks(monkeypatch):
    """With absorb off, MLA decode hands the decode wrapper (its checks run
    on the CPU as on the card) a packed v of head stride Dv != D; the
    reference's slice of the expanded (B, T, H, dn + dv) would be refused."""
    jcfg, cfg, params, tparams = _mla(False)
    seen = []
    real = fd_ops.decode_attention

    def spy(q, k, v, n):
        seen.append((q, k, v))
        return real(q, k, v, n)

    monkeypatch.setattr(fd_ops, "decode_attention", spy)
    rng = np.random.default_rng(14)
    cache = {"c_kv": _t(_np(rng, 2, 10, jcfg.kv_lora_rank)),
             "k_rope": _t(_np(rng, 2, 10, jcfg.qk_rope_dim))}
    tb.mla_apply(tparams, _t(_np(rng, 2, 1, jcfg.d_model)), cfg, mode="decode",
                 cache=cache, pos=4)
    (q, k, v), = seen
    H, dn, dr, dv = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    assert q.shape == (2, H, dn + dr) and k.shape == (2, 10, H, dn + dr)
    assert v.shape == (2, 10, H, dv) and v.stride()[2:] == (dv, 1)
    n = torch.tensor([5], dtype=torch.int32)
    fd_kernel._check(q, k, v, n)
    kv = torch.randn(2, 10, H, dn + dv)
    with pytest.raises(ValueError, match="strides"):
        fd_kernel._check(q, k, kv[..., dn:], n)


# --------------------------------------------------------------------------- #
# blocks, every family, both modes
# --------------------------------------------------------------------------- #
#: (config, layer): a MoE model's dense lead layer and a MoE layer
BLOCK_CASES = [("deepseek-v2-lite-16b", 0), ("deepseek-v2-lite-16b", 1),
               ("deepseek-v2-236b", 1), ("mamba2-2.7b", 0), ("hymba-1.5b", 1),
               ("musicgen-medium", 0), ("llava-next-mistral-7b", 1),
               ("smollm-135m", 0)]


@pytest.mark.parametrize("name,layer", BLOCK_CASES)
def test_block_apply_matches_jax_in_prefill_and_decode(name, layer):
    jcfg, cfg = _serve_cfgs(name)
    params, _, model = _model(jcfg, cfg, seed=layer)
    n_lead = jcfg.first_dense_layers if jcfg.family == "moe" else 0
    jp = (params["lead_blocks"][layer] if layer < n_lead else
          jax.tree_util.tree_map(lambda a: a[layer - n_lead], params["blocks"]))
    blk = model.layers()[layer]
    assert ("moe" in blk) == (jcfg.family == "moe" and layer >= n_lead)
    tol = SSD_TOL if jcfg.ssm_state else MODULE_TOL
    rng = np.random.default_rng(15)
    B, S = 2, 16
    x = _np(rng, B, S, jcfg.d_model)
    want, want_cache, want_aux = jb.block_apply(
        jp, jnp.asarray(x), jcfg, mode="prefill", window=jcfg.attn_window)
    with torch.no_grad():
        got, cache, aux = tb.block_apply(blk, _t(x), cfg, mode="prefill")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(float(aux), float(want_aux), **MODULE_TOL)
    _assert_tree_close(cache, want_cache, tol)
    # one decode step against the prefill's cache, 3 rows of room
    j_cache = jax.tree_util.tree_map(
        _jax_embed, _layer_cache(jm.init_caches(jcfg, B, S + 3), jcfg, layer),
        want_cache)
    t_cache = tm.init_caches(cfg, B, S + 3, "cpu")[layer]
    serve.fill_caches([t_cache], [cache])
    x1 = _np(rng, B, 1, jcfg.d_model)
    want, want_cache, want_aux = jb.block_apply(
        jp, jnp.asarray(x1), jcfg, mode="decode", cache=j_cache,
        pos=jnp.int32(S), window=jcfg.attn_window)
    with torch.no_grad():
        got, cache, aux = tb.block_apply(blk, _t(x1), cfg, mode="decode",
                                         cache=t_cache, pos=torch.tensor(S))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(float(aux), float(want_aux), **MODULE_TOL)
    _assert_tree_close(cache, want_cache, tol)
    _assert_tree_close(t_cache, want_cache, tol)  # the caller's, in place


# --------------------------------------------------------------------------- #
# whole models: prefill + 8 decode steps
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", FAMILIES)
def test_reduced_serve_matches_jax(name):
    """``serve.generate`` (prefill, then 8 decode steps) against the JAX
    ``make_prefill_step``/``make_decode_step`` in the example's loop: Hymba
    and LLaVA with a 16-row ring (16 prompt rows; LLaVA's 16 patch rows
    before 16 tokens), so that decode wraps it with S % W == 0; MusicGen
    with its codebooks, greedy per codebook."""
    jcfg, cfg = _serve_cfgs(name)
    params, _, model = _model(jcfg, cfg)
    B, S, new = 2, 16, 9
    prompts = serve.make_prompts(cfg, B, S, seed=1)
    patches = serve.make_patches(cfg, B, seed=1)
    assert (patches is not None) == (jcfg.family == "vlm")
    batch = {"tokens": jnp.asarray(prompts, jnp.int32)}
    if patches is not None:
        batch["patches"] = jnp.asarray(patches)
    start = S + (patches.shape[1] if patches is not None else 0)
    if jcfg.attn_window:
        assert start % jcfg.attn_window == 0 and start + new > jcfg.attn_window
    logits, pre = jax.jit(jm.make_prefill_step(jcfg))(params, batch)
    caches = jax.tree_util.tree_map(_jax_embed, jm.init_caches(jcfg, B, start + new),
                                    pre)
    decode = jax.jit(jm.make_decode_step(jcfg))
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want_tokens, want_logits = [tok], [logits[:, -1]]
    for t in range(new - 1):
        logits, caches = decode(params, {"tokens": tok}, jnp.int32(start + t),
                                caches)
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        want_tokens.append(tok)
        want_logits.append(logits[:, -1])
    fd_kernel.reset_launches()
    out = serve.generate(model, torch.as_tensor(prompts), new,
                         None if patches is None else torch.as_tensor(patches))
    assert fd_kernel.LAUNCHES["flash_decode"] == 0
    np.testing.assert_allclose(out["step_logits"].numpy(),
                               np.stack([np.asarray(a) for a in want_logits]),
                               **MODEL_TOL)
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  np.asarray(jnp.concatenate(want_tokens, axis=1)))
    shape = (B, new, cfg.num_codebooks) if cfg.num_codebooks else (B, new)
    assert tuple(out["tokens"].shape) == shape


# tests/test_transformer_correctness.py's small shapes, one per family;
# MoE at ample capacity (prefill and decode must drop the same set: none)
SMALL = {
    "moe": dict(num_heads=4, num_kv_heads=4, head_dim=16, use_mla=True,
                kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
                num_experts=4, num_shared_experts=1, moe_top_k=2, moe_d_ff=32,
                first_dense_layers=1, first_dense_d_ff=64,
                moe_capacity_factor=8.0),
    "hybrid": dict(num_heads=4, num_kv_heads=2, head_dim=16, d_ff=64,
                   ssm_state=8, ssm_expand=2, ssm_headdim=16, ssm_chunk=4),
    "ssm": dict(ssm_state=8, ssm_expand=2, ssm_headdim=16, ssm_chunk=4),
    "audio": dict(num_heads=4, num_kv_heads=4, head_dim=16, d_ff=64,
                  num_codebooks=3, mlp_type="mlp"),
    "vlm": dict(num_heads=4, num_kv_heads=2, head_dim=16, d_ff=64,
                num_patches=4),
}


@pytest.mark.parametrize("family", list(SMALL))
def test_teacher_forced_decode_equals_prefill(family):
    """Inside the port: a prefill over S tokens, then 4 teacher-forced decode
    steps give the logits of a prefill over S + 4 tokens (1e-4: the same
    function, another order of sums; the SSD's chunked pass against its
    recurrence)."""
    cfg = ArchConfig(name="t", family=family, num_layers=2, d_model=64,
                     vocab_size=97, dtype="float32", **SMALL[family])
    model = tm.init_params(cfg, torch.Generator().manual_seed(0))
    B, S = 2, 8
    rng = np.random.default_rng(1)
    shape = (B, S + 4) + ((cfg.num_codebooks,) if cfg.num_codebooks else ())
    toks = torch.as_tensor(rng.integers(0, 97, shape))
    patches = (torch.as_tensor(_np(rng, B, cfg.num_patches, 64))
               if cfg.num_patches else None)
    Np = cfg.num_patches
    with torch.no_grad():
        full, _, _ = tm.forward(model, toks, patches=patches, mode="prefill")
        last, pre = tm.make_prefill_step(cfg)(model, toks[:, :S], patches)
        torch.testing.assert_close(last[:, 0], full[:, Np + S - 1], **MODEL_TOL)
        caches = tm.init_caches(cfg, B, Np + S + 4, "cpu")
        serve.fill_caches(caches, pre)
        decode = tm.make_decode_step(cfg)
        for t in range(4):
            logits, caches = decode(model, toks[:, S + t:S + t + 1], Np + S + t,
                                    caches)
            torch.testing.assert_close(logits[:, 0], full[:, Np + S + t],
                                       **MODEL_TOL)


# --------------------------------------------------------------------------- #
# transformer_params_from_jax
# --------------------------------------------------------------------------- #
def _set(tree, path, value):
    """A copy of ``tree`` with the leaf at ``path`` replaced (or deleted)."""
    out = dict(tree)
    if len(path) == 1:
        if value is None:
            del out[path[0]]
        else:
            out[path[0]] = value
        return out
    out[path[0]] = _set(tree[path[0]], path[1:], value)
    return out


#: a nested leaf of each family to break: (config, path under "blocks")
LEAVES = {"deepseek-v2-lite-16b": ("moe", "shared", "w_in"),
          "deepseek-v2-236b": ("attn", "wq_b"),
          "mamba2-2.7b": ("ssm", "in_proj"),
          "hymba-1.5b": ("ssm", "A_log"),
          "musicgen-medium": ("mlp", "w_out"),
          "llava-next-mistral-7b": ("attn", "wk")}


@pytest.mark.parametrize("name", FAMILIES)
def test_params_from_jax_checks_every_family(name):
    jcfg, cfg = _serve_cfgs(name)
    _, np_params, model = _model(jcfg, cfg)
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(np_params))
    assert len(model.layers()) == cfg.num_layers
    assert len(model.lead_blocks) == (1 if cfg.family == "moe" else 0)
    if cfg.num_codebooks:
        assert model.embed.shape == (cfg.num_codebooks, cfg.vocab_size, cfg.d_model)
        assert model.lm_head.shape == (cfg.d_model,
                                       cfg.num_codebooks * cfg.vocab_size)
    path = ("blocks",) + LEAVES[name]
    leaf = np_params
    for k in path:
        leaf = leaf[k]
    with pytest.raises(ValueError, match="shape"):
        tm.transformer_params_from_jax(_set(np_params, path, leaf[..., :-1]),
                                       cfg, "cpu")
    with pytest.raises(ValueError, match="block parameters"):
        tm.transformer_params_from_jax(_set(np_params, path, None), cfg, "cpu")
    with pytest.raises(ValueError, match="layers"):
        tm.transformer_params_from_jax(
            dict(np_params, blocks=jax.tree_util.tree_map(lambda a: a[:0],
                                                          np_params["blocks"])),
            cfg, "cpu")
    if cfg.family == "moe":
        with pytest.raises(ValueError, match="names"):
            tm.transformer_params_from_jax(_set(np_params, ("lead_blocks",), None),
                                           cfg, "cpu")
        with pytest.raises(ValueError, match="lead blocks"):
            tm.transformer_params_from_jax(
                dict(np_params, lead_blocks=np_params["lead_blocks"] * 2), cfg, "cpu")
        # a lead block is dense, a scanned block MoE
        bad = [dict(np_params["lead_blocks"][0], moe=np_params["blocks"]["moe"])]
        with pytest.raises(ValueError, match="block parameters"):
            tm.transformer_params_from_jax(dict(np_params, lead_blocks=bad), cfg,
                                           "cpu")


@pytest.mark.parametrize("name", ["deepseek-v2-236b", "hymba-1.5b",
                                  "musicgen-medium"])
def test_params_from_jax_carries_bfloat16_bitwise(name):
    """bfloat16 leaves bit for bit; the norms, the SSM's vectors and the
    router stay float32 as in the reference."""
    jcfg = j_get_arch(name).reduced(dtype="bfloat16")
    np_params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(2), jcfg))
    model = tm.transformer_params_from_jax(
        np_params, get_arch(name).reduced(dtype="bfloat16"), "cpu")
    flat = tm._flatten({"blocks": np_params["blocks"]})
    for i, blk in enumerate(model.blocks):
        for n, t in blk.named_parameters():
            want = flat[f"blocks.{n}"][i]
            assert str(want.dtype) == {torch.bfloat16: "bfloat16",
                                       torch.float32: "float32"}[t.dtype], n
            if t.dtype == torch.bfloat16:
                np.testing.assert_array_equal(t.detach().view(torch.int16).numpy(),
                                              want.view(np.int16))
            else:
                np.testing.assert_array_equal(t.detach().numpy(), want)


# --------------------------------------------------------------------------- #
# the serve entry point
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", j_list_archs())
def test_serve_cli_runs_every_arch_on_cpu(name, capsys):
    out = serve.main(["--arch", name, "--reduced", "--device", "cpu", "--batch",
                      "2", "--prompt-len", "16", "--new-tokens", "4"])
    cfg = serve.serve_config(name, reduced=True)
    nc = cfg.num_codebooks
    assert tuple(out["tokens"].shape) == ((2, 4, nc) if nc else (2, 4))
    assert torch.isfinite(out["logits"]).all()
    text = capsys.readouterr().out
    assert f"serving {name}" in text and "tokens/s" in text
    if cfg.num_patches:
        assert f"+ {cfg.num_patches} patch rows" in text


def test_serve_refuses_patches_for_a_model_without_them():
    cfg = serve.serve_config("smollm-135m", reduced=True)
    model = tm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="patches"):
        serve.generate(model, torch.zeros((1, 4), dtype=torch.int64), 2,
                       torch.zeros((1, 2, cfg.d_model)))


def test_serve_depth_cut_keeps_widths():
    cfg = serve.serve_config("deepseek-v2-236b", reduced=False, layers=2)
    full = get_arch("deepseek-v2-236b")
    assert cfg.num_layers == 2 and cfg.first_dense_layers == 1
    assert dataclasses.replace(cfg, num_layers=full.num_layers) == full
