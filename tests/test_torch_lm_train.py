"""The port's transformer train path against the JAX package's, on the CPU:
train mode of every block, the differentiable SSD, ``lm_loss`` and its
gradients for all ten configs, per-layer remat, and ``sgd``'s momentum.
The three-step trajectories are in ``test_torch_lm_train_step.py``.

Weights are the JAX ``init_params``/``*_init``, carried over with
``transformer_params_from_jax`` (or as numpy dicts for a module), and
``jax_tree`` carries the port's weights (or gradients) back as the JAX
pytree; inputs come from numpy seeds. The configs are the ``reduced()``
ones in float32, B = 2, S = 32 (the reduced SSD chunk is 16),
``attn_window=16`` where the config has a window, as
``tests/test_arch_smoke.py`` runs them. Tolerances, all float32:

* modules (attention, MoE, a block without an SSD): rtol/atol 1e-5;
* the SSD and a block that runs it: 1e-4 (its chunked exponentials, summed
  in another order than XLA's);
* a module's gradients: the same rtol, and an atol of the same size in
  units of the leaf's largest entry (``assert_scaled_close``: a block's
  gradients reach 20 and more at these inputs, where float32 sums of 256
  terms differ in the fifth digit);
* ``lm_loss``: the loss and aux 1e-5, every gradient 1e-4;
* the train forward against prefill, remat against none: bit for bit.
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
from repro.models.transformer import layers as jl
from repro.models.transformer import model as jm
from repro.models.transformer import moe as jmoe
from repro.models.transformer import ssm as jssm
from repro.models.transformer.config import ArchConfig as JArchConfig
from repro.train import optimizer as j_opt
from repro_torch.models.transformer import blocks as tb
from repro_torch.models.transformer import layers as tl
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer import moe as tmoe
from repro_torch.models.transformer import ssm as tssm
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.train import optimizer as t_opt

MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
SSD_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = j_list_archs()
B, S = 2, 32


def _np(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _both(jcfg):
    """The port's ``ArchConfig`` with the values of a JAX one."""
    return ArchConfig(**dataclasses.asdict(jcfg))


def train_cfgs(name, **overrides):
    """(JAX config, the port's) of ``name``'s reduced train variant."""
    full = j_get_arch(name)
    jcfg = full.reduced(attn_window=16 if full.attn_window else None,
                        **overrides)
    return jcfg, _both(jcfg)


def train_model(jcfg, cfg, seed=0):
    """(JAX params, the port's model holding the same weights)."""
    params = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    model = tm.transformer_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg, "cpu")
    return params, model


def train_batch(cfg, seed=1):
    """(JAX batch, tokens, patches or None) from a numpy seed: B x S tokens
    (x nc codebooks), and a VLM's B x Np x d patch rows."""
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.num_codebooks) if cfg.num_codebooks else (B, S)
    tokens = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    patches = None
    if cfg.num_patches:
        patches = _np(rng, B, cfg.num_patches, cfg.d_model)
        batch["patches"] = jnp.asarray(patches)
    return batch, torch.as_tensor(tokens).long(), (
        None if patches is None else _t(patches))


def jax_tree(model, values=None) -> dict:
    """The port's parameters, or ``values`` (one tensor per parameter, in
    ``model.parameters()``'s order: gradients, say), as the JAX package's
    pytree of float32 numpy arrays: the top leaves, ``lead_blocks`` a list
    and ``blocks`` stacked on a leading layer axis."""
    names = [n for n, _ in model.named_parameters()]
    values = list(model.parameters()) if values is None else list(values)
    assert len(values) == len(names)
    flat = {n: v.detach().float().numpy() for n, v in zip(names, values)}

    def block(prefix, i):
        head = f"{prefix}.{i}."
        return tm._unflatten({n[len(head):]: a for n, a in flat.items()
                              if n.startswith(head)})

    tree = {n: flat[n] for n in ("embed", "final_norm", "lm_head") if n in flat}
    if len(model.lead_blocks):
        tree["lead_blocks"] = [block("lead_blocks", i)
                               for i in range(len(model.lead_blocks))]
    tree["blocks"] = jax.tree_util.tree_map(
        lambda *xs: np.stack(xs), *[block("blocks", i)
                                    for i in range(len(model.blocks))])
    return tree


def assert_trees_close(got: dict, want: dict, tol: dict):
    """Every leaf of two pytrees of the same structure within ``tol``."""
    g = jax.tree_util.tree_leaves_with_path(got)
    w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), **tol,
                                   err_msg=jax.tree_util.keystr(path))


def assert_scaled_close(got, want, tol: dict, name=""):
    """``got`` within rtol, and within atol times the largest |entry| of
    ``want``."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=tol["rtol"],
        atol=tol["atol"] * max(float(np.abs(want).max()), 1.0), err_msg=name)


def _grads_of(fn, tensors):
    """(fn's value, d value / d tensors) with every tensor a fresh leaf."""
    leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves)


# --------------------------------------------------------------------------- #
# the SSD's backward
# --------------------------------------------------------------------------- #
SSM_CFGS = {
    "small": JArchConfig(name="t", family="ssm", num_layers=1, d_model=32,
                         vocab_size=64, ssm_state=8, ssm_expand=2,
                         ssm_headdim=16, ssm_chunk=4, ssm_ngroups=1),
    "groups": JArchConfig(name="t", family="ssm", num_layers=1, d_model=32,
                          vocab_size=64, ssm_state=8, ssm_expand=2,
                          ssm_headdim=8, ssm_chunk=8, ssm_ngroups=2),
    "mamba2": j_get_arch("mamba2-2.7b").reduced(),
    "hymba": j_get_arch("hymba-1.5b").reduced(),
}
SSM_LEAVES = ("in_proj", "out_proj", "A_log", "D", "dt_bias", "norm_scale")


@pytest.mark.parametrize("name", list(SSM_CFGS))
def test_ssm_apply_train_gradients_match_jax(name):
    """d <out, cot> / d (x, every SSD leaf) against ``jax.grad`` of the
    reference, over 4 chunks. It also pins the backward itself: an in-place
    exponential in the chunked pass made autograd raise."""
    jcfg = SSM_CFGS[name]
    cfg = _both(jcfg)
    params = jssm.ssm_init(jax.random.PRNGKey(7), jcfg, jnp.float32)
    rng = np.random.default_rng(21)
    x = _np(rng, 2, 4 * jcfg.ssm_chunk, jcfg.d_model, scale=0.5)
    cot = _np(rng, *x.shape)

    def j_fn(p, x):
        return jnp.sum(jssm.ssm_apply_train(p, x, jcfg) * cot)

    want, (want_p, want_x) = jax.jit(jax.value_and_grad(j_fn, argnums=(0, 1)))(
        params, jnp.asarray(x))

    def t_fn(x, *leaves):
        p = dict(zip(SSM_LEAVES, leaves))
        return (tssm.ssm_apply_train(p, x, cfg) * _t(cot)).sum()

    got, grads = _grads_of(t_fn, [_t(x)] + [_t(params[n]) for n in SSM_LEAVES])
    np.testing.assert_allclose(float(got.detach()), float(want), **SSD_TOL)
    assert_scaled_close(grads[0].numpy(), want_x, SSD_TOL, "x")
    for n, g in zip(SSM_LEAVES, grads[1:]):
        assert_scaled_close(g.numpy(), want_p[n], SSD_TOL, n)


def test_ssm_apply_train_gradient_is_finite_where_the_masked_exponent_overflows():
    """With large inputs and a chunk of 64, cum_i - cum_j above the diagonal
    overflows exp: the port masks the exponent before exp, so every
    gradient stays finite (the reference's, ``0 * inf`` in exp's adjoint,
    is NaN there), and the forward still matches the reference's (atol in
    units of its largest entry: these inputs are 4x the others')."""
    jcfg = dataclasses.replace(SSM_CFGS["mamba2"], ssm_chunk=64)
    cfg = _both(jcfg)
    params = jssm.ssm_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    rng = np.random.default_rng(28)
    x = _np(rng, 2, 128, jcfg.d_model, scale=4.0)
    want = jssm.ssm_apply_train(params, jnp.asarray(x), jcfg)
    got, grads = _grads_of(
        lambda x, *ls: (tssm.ssm_apply_train(dict(zip(SSM_LEAVES, ls)), x, cfg)
                        * _t(_np(rng, *x.shape))).sum(),
        [_t(x)] + [_t(params[n]) for n in SSM_LEAVES])
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    with torch.no_grad():
        out = tssm.ssm_apply_train({n: _t(params[n]) for n in SSM_LEAVES},
                                   _t(x), cfg)
    assert_scaled_close(out.numpy(), want, SSD_TOL, "out")


def test_ssm_apply_train_is_unchanged_under_inference_mode():
    """The out-of-place pass gives the same bits with autograd on and under
    ``inference_mode`` (serve)."""
    jcfg = SSM_CFGS["mamba2"]
    cfg = _both(jcfg)
    p = jax.tree_util.tree_map(
        lambda a: _t(np.array(a)),
        jssm.ssm_init(jax.random.PRNGKey(7), jcfg, jnp.float32))
    x = _t(_np(np.random.default_rng(22), 2, 64, jcfg.d_model, scale=0.5))
    with torch.inference_mode():
        served = tssm.ssm_apply_train(p, x, cfg)
    trained = tssm.ssm_apply_train(p, x.clone().requires_grad_(True), cfg)
    assert torch.equal(served, trained.detach())


# --------------------------------------------------------------------------- #
# attention's backward: full and chunked-flash
# --------------------------------------------------------------------------- #
#: (H, KV, D, Dv): GQA with 2 query heads a KV head; MLA's D != Dv
ATTN_SHAPES = {"gqa": (4, 2, 16, 16), "mla": (4, 4, 24, 16)}


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("shape", list(ATTN_SHAPES))
@pytest.mark.parametrize("kind", ["full", "flash"])
def test_attention_gradients_match_jax(kind, shape, window):
    """d <out, cot> / d (q, k, v) at S = 32 (flash: chunk 8, so 4 x 4
    blocks, the masked ones included) against the reference's."""
    H, KV, D, Dv = ATTN_SHAPES[shape]
    rng = np.random.default_rng(23)
    q, k, v = _np(rng, B, S, H, D), _np(rng, B, S, KV, D), _np(rng, B, S, KV, Dv)
    cot = _np(rng, B, S, H, Dv)
    if kind == "full":
        j_att = lambda q, k, v: jl.attention_full(q, k, v, causal=True,  # noqa: E731
                                                  window=window)
        t_att = lambda q, k, v: tl.attention_full(q, k, v, causal=True,  # noqa: E731
                                                  window=window)
    else:
        j_att = lambda q, k, v: jl.attention_flash(q, k, v, chunk=8,  # noqa: E731
                                                   window=window)
        t_att = lambda q, k, v: tl.attention_flash(q, k, v, chunk=8,  # noqa: E731
                                                   window=window)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda *a: jnp.sum(j_att(*a) * cot), argnums=(0, 1, 2)))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got, grads = _grads_of(lambda *a: (t_att(*a) * _t(cot)).sum(),
                           [_t(q), _t(k), _t(v)])
    np.testing.assert_allclose(float(got.detach()), float(want), **MODULE_TOL)
    for name, g, w in zip("qkv", grads, want_g):
        assert_scaled_close(g.numpy(), w, MODULE_TOL, name)


def _flash_every_block(q, k, v, chunk, window):
    """The online-softmax loop visiting and masking every block, as the JAX
    scan does."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    ar = torch.arange(chunk)
    outs = []
    for qi in range(S // chunk):
        m = torch.full((B, H, chunk), tl.MASK_VALUE)
        d = torch.zeros((B, H, chunk))
        acc = torch.zeros((B, H, chunk, v.shape[3]))
        for kj in range(S // chunk):
            s = torch.einsum("bqhd,bkhd->bhqk", q[:, qi * chunk:(qi + 1) * chunk],
                             k[:, kj * chunk:(kj + 1) * chunk]).float() * (
                                 1.0 / np.sqrt(D))
            qp, kp = qi * chunk + ar, kj * chunk + ar
            msk = qp[:, None] >= kp[None, :]
            if window is not None:
                msk &= qp[:, None] - kp[None, :] < window
            s = torch.where(msk, s, tl.MASK_VALUE)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            d = d * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(q.dtype),
                v[:, kj * chunk:(kj + 1) * chunk]).float()
            m = m_new
        outs.append((acc / d[..., None].clamp(min=1e-30)).to(q.dtype))
    return torch.stack(outs, dim=2).reshape(B, H, S, -1).transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 8, 20])
@pytest.mark.parametrize("shape", list(ATTN_SHAPES))
def test_attention_flash_skips_dead_blocks_with_the_same_values(shape, window,
                                                                 dtype):
    """``attention_flash`` visits only the blocks holding an unmasked score
    (S = 64, chunk 8: 8 x 8 blocks; windows
    of one chunk and of two and a half): with and without autograd its
    output equals the loop over every block, as the JAX scan runs it."""
    H, KV, D, Dv = ATTN_SHAPES[shape]
    rng = np.random.default_rng(27)
    q, k, v = (_t(_np(rng, B, 64, h, e)).to(dtype)
               for h, e in ((H, D), (KV, D), (KV, Dv)))
    every = _flash_every_block(q, k, v, 8, window)
    with torch.no_grad():
        served = tl.attention_flash(q, k, v, chunk=8, window=window)
    trained = tl.attention_flash(q.requires_grad_(True), k, v, chunk=8,
                                 window=window)
    assert trained.grad_fn is not None
    assert torch.equal(served, every) and torch.equal(trained.detach(), every)


# --------------------------------------------------------------------------- #
# MoE: the aux loss reaches the router
# --------------------------------------------------------------------------- #
def _moe_cfg(mlp_type, cf, shared=1):
    return JArchConfig(
        name="t", family="moe", num_layers=1, d_model=32, vocab_size=64,
        num_experts=4, moe_top_k=2, moe_d_ff=16, num_shared_experts=shared,
        moe_capacity_factor=cf, mlp_type=mlp_type, dtype="float32")


@pytest.mark.parametrize("mlp_type", ["swiglu", "mlp"])
@pytest.mark.parametrize("cf", [1.0, 8.0])
def test_moe_apply_gradients_match_jax(mlp_type, cf):
    """d (<out, cot> + 0.01 aux) / d (x, every MoE leaf) at a capacity that
    drops tokens (1.0) and at one that drops none (8.0): the top-k
    renormalisation and the aux loss reach the router's gradient as in
    ``jax.grad`` of the reference."""
    jcfg = _moe_cfg(mlp_type, cf, shared=1 if mlp_type == "swiglu" else 0)
    cfg = _both(jcfg)
    params = jmoe.moe_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    rng = np.random.default_rng(24)
    x = _np(rng, 2, 24, 32)
    cot = _np(rng, *x.shape)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(params)]
    leaves, treedef = jax.tree_util.tree_flatten(params)

    def j_fn(p, x):
        out, aux = jmoe.moe_apply(p, x, jcfg)
        return jnp.sum(out * cot) + 0.01 * aux

    want, (want_p, want_x) = jax.jit(jax.value_and_grad(j_fn, argnums=(0, 1)))(
        params, jnp.asarray(x))

    def t_fn(x, *ls):
        p = jax.tree_util.tree_unflatten(treedef, ls)
        out, aux = tmoe.moe_apply(p, x, cfg)
        return (out * _t(cot)).sum() + 0.01 * aux

    got, grads = _grads_of(t_fn, [_t(x)] + [_t(np.array(a)) for a in leaves])
    np.testing.assert_allclose(float(got.detach()), float(want), **MODULE_TOL)
    assert_scaled_close(grads[0].numpy(), want_x, MODULE_TOL, "x")
    for name, g, w in zip(names, grads[1:], jax.tree_util.tree_leaves(want_p)):
        assert_scaled_close(g.numpy(), w, MODULE_TOL, name)
    router = grads[1 + names.index("['router']")]
    assert float(router.abs().max()) > 0


# --------------------------------------------------------------------------- #
# blocks in train mode, every family
# --------------------------------------------------------------------------- #
#: (config, layer): a MoE model's dense lead layer and a MoE layer
BLOCK_CASES = [("deepseek-v2-lite-16b", 0), ("deepseek-v2-lite-16b", 1),
               ("deepseek-v2-236b", 1), ("mamba2-2.7b", 0), ("hymba-1.5b", 1),
               ("musicgen-medium", 0), ("llava-next-mistral-7b", 1),
               ("smollm-135m", 0)]


@pytest.mark.parametrize("name,layer", BLOCK_CASES)
def test_block_apply_train_matches_jax(name, layer):
    """``block_apply(mode="train")``: output, aux, no cache, and the
    gradients of <out, cot> + 0.01 aux over x and every block leaf."""
    jcfg, cfg = train_cfgs(name)
    params, model = train_model(jcfg, cfg, seed=layer)
    n_lead = jcfg.first_dense_layers if jcfg.family == "moe" else 0
    jp = (params["lead_blocks"][layer] if layer < n_lead else
          jax.tree_util.tree_map(lambda a: a[layer - n_lead], params["blocks"]))
    blk = model.layers()[layer]
    tol = SSD_TOL if jcfg.ssm_state else MODULE_TOL
    rng = np.random.default_rng(25)
    x = _np(rng, B, S, jcfg.d_model)
    cot = _np(rng, *x.shape)

    def j_fn(p, x):
        out, cache, aux = jb.block_apply(p, x, jcfg, mode="train",
                                         window=jcfg.attn_window)
        assert cache is None
        return jnp.sum(out * cot) + 0.01 * aux, aux

    (want, want_aux), (want_p, want_x) = jax.jit(jax.value_and_grad(
        j_fn, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    out, cache, aux = tb.block_apply(blk, xt, cfg, mode="train")
    assert cache is None
    got = (out * _t(cot)).sum() + 0.01 * aux
    names = [n for n, _ in blk.named_parameters()]
    grads = torch.autograd.grad(got, [xt, *blk.parameters()])
    np.testing.assert_allclose(float(got.detach()), float(want), **tol)
    np.testing.assert_allclose(float(aux), float(want_aux), **MODULE_TOL)
    assert_scaled_close(grads[0].numpy(), want_x, tol, "x")
    flat = tm._flatten(jax.tree_util.tree_map(np.asarray, want_p))
    assert sorted(names) == sorted(flat)
    for n, g in zip(names, grads[1:]):
        assert_scaled_close(g.numpy(), flat[n], tol, n)
    with pytest.raises(ValueError, match="mode"):
        tb.block_apply(blk, xt, cfg, mode="generate")


# --------------------------------------------------------------------------- #
# lm_loss, all ten configs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ARCHS)
def test_lm_loss_and_gradients_match_jax(name):
    """``lm_loss``'s total, loss and aux against ``jax.value_and_grad`` of
    the reference's, and every parameter's gradient: each one exists (the
    SSD's included) and has a nonzero entry."""
    jcfg, cfg = train_cfgs(name)
    params, model = train_model(jcfg, cfg)
    batch, tokens, patches = train_batch(cfg)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p: jm.lm_loss(p, jcfg, batch), has_aux=True))(params)
    total, metrics = tm.lm_loss(model, tokens, patches)
    grads = torch.autograd.grad(total, list(model.parameters()))
    np.testing.assert_allclose(float(total.detach()), float(want), **LOSS_TOL)
    for k in ("loss", "aux"):
        np.testing.assert_allclose(float(metrics[k]), float(want_m[k]), **LOSS_TOL)
    assert (float(metrics["aux"]) > 0) == (cfg.family == "moe")
    for (n, _), g in zip(model.named_parameters(), grads):
        assert bool((g != 0).any()), f"{name}: {n} gets no gradient"
    assert_trees_close(jax_tree(model, grads),
                       jax.tree_util.tree_map(np.asarray, want_g), GRAD_TOL)


# --------------------------------------------------------------------------- #
# train mode against prefill, remat against none
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ARCHS)
def test_train_forward_logits_equal_prefill_bitwise(name):
    """The train forward (under remat, with autograd on) computes the
    prefill's logits bit for bit and emits no cache; the aux is the sum of
    the layers'."""
    jcfg, cfg = train_cfgs(name)
    _, model = train_model(jcfg, cfg)
    _, tokens, patches = train_batch(cfg)
    assert cfg.opt_remat == "full"
    logits, caches, aux = tm.forward(model, tokens, patches=patches, mode="train")
    assert caches is None and logits.requires_grad
    with torch.no_grad():
        pre, pre_caches, pre_aux = tm.forward(model, tokens, patches=patches,
                                              mode="prefill")
    assert len(pre_caches) == cfg.num_layers
    assert torch.equal(logits.detach(), pre) and torch.equal(aux.detach(), pre_aux)
    with pytest.raises(ValueError, match="mode"):
        tm.forward(model, tokens, patches=patches, mode="decode")


@pytest.mark.parametrize("name", ARCHS)
def test_remat_full_and_none_give_the_same_bits(name):
    """``opt_remat="full"`` (each block under ``torch.utils.checkpoint``)
    and ``"none"``: the same loss and gradients bit for bit; a MoE block
    routes its recompute as its first forward did."""
    jcfg, cfg = train_cfgs(name)
    _, model = train_model(jcfg, cfg)
    _, tokens, patches = train_batch(cfg)
    out = {}
    for remat in ("full", "none"):
        model.cfg = dataclasses.replace(cfg, opt_remat=remat)
        total, _ = tm.lm_loss(model, tokens, patches)
        out[remat] = (total, torch.autograd.grad(total, list(model.parameters())))
    assert torch.equal(out["full"][0], out["none"][0])
    for a, b in zip(out["full"][1], out["none"][1]):
        assert torch.equal(a, b)


def test_bad_remat_raises():
    jcfg, cfg = train_cfgs("smollm-135m")
    _, model = train_model(jcfg, cfg)
    _, tokens, _ = train_batch(cfg)
    bad = dataclasses.replace(cfg, opt_remat="offload")
    with pytest.raises(ValueError, match="opt_remat"):
        tm.make_train_step(bad, t_opt.adamw(1e-3))
    model.cfg = bad
    with pytest.raises(ValueError, match="opt_remat"):
        tm.lm_loss(model, tokens)
    with torch.no_grad():  # prefill never remats: any value runs
        tm.forward(model, tokens, mode="prefill")


# --------------------------------------------------------------------------- #
# sgd with momentum
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_the_reference(momentum):
    """Three steps of ``sgd(lr, momentum)`` over mixed leaves against the
    reference's: params and the velocity slot (1e-6; none at momentum 0)."""
    rng = np.random.default_rng(26)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [_np(rng, *s) for s in shapes]
    grads = [[_np(rng, *s) for s in shapes] for _ in range(3)]
    j = j_opt.sgd(0.1, momentum=momentum)
    jp = [jnp.asarray(p) for p in params]
    js = j.init(jp)
    t = t_opt.sgd(0.1, momentum=momentum)
    tp = [_t(p).clone() for p in params]
    ts = t.init(tp)
    for g in grads:
        jp, js = j.update([jnp.asarray(a) for a in g], js, jp)
        out, ts = t.update([_t(a) for a in g], ts, tp)
        assert out is tp  # in place
    assert ts.step == 3 and int(js.step) == 3
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    assert len(ts.slots) == len(js.slots) == (3 if momentum else 0)
    for a, b in zip(ts.slots, js.slots):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_adamw_takes_a_bf16_leafs_step_in_float32():
    """One ``adamw(1e-3)`` step over a bf16 leaf and a float32 one against
    the reference's: the reference's step is float32 (its bias corrections
    are) and returns a float32 weight; the port's bf16 leaf stays bf16, and
    lies within one bf16 ulp of the reference's weight plus 1% of lr (both
    packages round ``m`` and ``v`` to bf16, each about 2^-9 of the step,
    where XLA may fuse ``g * g`` into the sum) and is its rounding for more
    than 95% of the entries; the float32 leaf within 1e-6."""
    rng = np.random.default_rng(28)
    params = [_np(rng, 64, 48, scale=0.02), _np(rng, 48)]
    grads = [_np(rng, 64, 48, scale=1e-3), _np(rng, 48, scale=1e-3)]
    dts = [torch.bfloat16, torch.float32]
    tp = [_t(p).to(dt) for p, dt in zip(params, dts)]
    tg = [_t(g).to(dt) for g, dt in zip(grads, dts)]
    jp = [jnp.asarray(p.float().numpy()).astype(jnp.bfloat16 if dt == torch.bfloat16
                                                 else jnp.float32)
          for p, dt in zip(tp, dts)]
    jg = [jnp.asarray(g.float().numpy()).astype(a.dtype) for g, a in zip(tg, jp)]
    j = j_opt.adamw(1e-3)
    jp, _ = j.update(jg, j.init(jp), jp)
    t = t_opt.adamw(1e-3)
    t.update(tg, t.init(tp), tp)
    assert tp[0].dtype == torch.bfloat16 and jp[0].dtype == jnp.float32
    ref = np.asarray(jp[0])
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref))) - 7)
    got = tp[0].float().numpy()
    assert (np.abs(got - ref) <= ulp + 1e-2 * 1e-3).all()
    rounded = torch.from_numpy(ref.copy()).bfloat16().float().numpy()
    assert (got == rounded).mean() > 0.95
    np.testing.assert_allclose(tp[1].numpy(), np.asarray(jp[1]), rtol=1e-6, atol=1e-6)


def test_adamw_in_slices_gives_the_same_bits(monkeypatch):
    """``adamw`` updates a leaf ``SLICE`` elements at a time; three steps
    over bf16 and float32 leaves (a matrix, a vector, a scalar) at a slice
    of 7 elements give the same weights and slots, bit for bit, as at the
    default slice, which holds each leaf whole."""
    shapes = [(12, 5), (9,), ()]
    out = []
    for sl in (t_opt.SLICE, 7):
        monkeypatch.setattr(t_opt, "SLICE", sl)
        for dt in (torch.bfloat16, torch.float32):
            rng = np.random.default_rng(29)
            params = [_t(_np(rng, *s)).to(dt) for s in shapes]
            opt = t_opt.adamw(1e-3)
            state = opt.init(params)
            for _ in range(3):
                opt.update([_t(_np(rng, *s)).to(dt) for s in shapes], state, params)
            out.append(params + state.slots["m"] + state.slots["v"])
    for a, b in zip(out[:2], out[2:]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
