"""The port's transformer serve path against the JAX package's, on the CPU,
where the decode-attention wrapper runs its kernel's plain version.

Inputs come from numpy seeds; weights are the JAX ``init_params``, carried
over with ``transformer_params_from_jax``. Tolerances (all float32):

* layers: rtol 2e-5 (atol 2e-6 for values near 0): the same arithmetic in
  another library, summed in another order;
* ``decode_attention_ref`` against the Pallas kernel (interpret mode) and
  JAX's oracle: rtol 2e-4 / atol 2e-5, ``tests/test_kernels.py``'s own;
* whole models (prefill logits and caches, then decode steps): rtol 1e-4 /
  atol 1e-4 over two layers and the head, and the greedy tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.kernels.flash_decode.ops import decode_attention_pallas
from repro.kernels.flash_decode.ref import decode_attention_ref as j_decode_ref
from repro.models.transformer import layers as jl
from repro.models.transformer import model as jm
from repro_torch import serve
from repro_torch.configs import get_arch, list_archs
from repro_torch.kernels.flash_decode import kernel as fd_kernel
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode.ref import decode_attention_ref
from repro_torch.models.transformer import layers as tl
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer.config import ArchConfig

DENSE = ["smollm-135m", "phi3-mini-3.8b", "gemma-7b", "granite-20b"]
LAYER_TOL = dict(rtol=2e-5, atol=2e-6)
KERNEL_TOL = dict(rtol=2e-4, atol=2e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# --------------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------------- #
def test_dense_configs_equal_the_reference():
    assert list_archs() == sorted(DENSE)
    for name in DENSE:
        assert dataclasses.asdict(get_arch(name)) == dataclasses.asdict(
            j_get_arch(name))
        assert dataclasses.asdict(get_arch(name).reduced()) == dataclasses.asdict(
            j_get_arch(name).reduced())
        assert get_arch(name).param_count() == j_get_arch(name).param_count()


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "mamba2-2.7b",
                                  "hymba-1.5b", "musicgen-medium",
                                  "llava-next-mistral-7b"])
def test_unported_family_raises(name):
    cfg = ArchConfig(**dataclasses.asdict(j_get_arch(name)).copy()).reduced()
    with pytest.raises(ValueError, match=repr(cfg.family)):
        tm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="not ported"):
        tm.make_decode_step(cfg)


# --------------------------------------------------------------------------- #
# layers, float32
# --------------------------------------------------------------------------- #
def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x, scale = _np(rng, 3, 5, 64, scale=3.0), _np(rng, 64)
    want = jl.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    got = tl.rms_norm(_t(x), _t(scale), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = _np(rng, 2, 12, 3, 32)
    pos = np.arange(100, 112)[None, :]
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = tl.apply_rope(_t(x), _t(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    for D, theta in ((32, 500.0), (64, 10000.0), (96, 10000.0), (256, 10000.0)):
        np.testing.assert_array_equal(tl.rope_freqs(D, theta), jl.rope_freqs(D, theta))
        np.testing.assert_array_equal(  # the table apply_rope computes in torch
            tl._rope_freqs_on(D, theta, "cpu").numpy(),
            tl.rope_freqs(D, theta).astype(np.float32))


def _qkv(seed, B, S, H, KV, D):
    rng = np.random.default_rng(seed)
    return _np(rng, B, S, H, D), _np(rng, B, S, KV, D), _np(rng, B, S, KV, D)


@pytest.mark.parametrize("window", [None, 5])
def test_attention_full_matches_jax(window):
    q, k, v = _qkv(2, 2, 24, 6, 2, 16)
    want = jl.attention_full(*map(jnp.asarray, (q, k, v)), causal=True,
                             window=window)
    got = tl.attention_full(_t(q), _t(k), _t(v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_attention_flash_matches_jax_and_full():
    q, k, v = _qkv(3, 2, 64, 4, 2, 16)
    want = jl.attention_flash(*map(jnp.asarray, (q, k, v)), chunk=16)
    got = tl.attention_flash(_t(q), _t(k), _t(v), chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    full = tl.attention_full(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **LAYER_TOL)


@pytest.mark.parametrize("cache_len", [1, 37, 48])
def test_attention_decode_matches_jax(cache_len):
    rng = np.random.default_rng(cache_len)
    q = _np(rng, 3, 1, 6, 32)
    k, v = _np(rng, 3, 48, 2, 32), _np(rng, 3, 48, 2, 32)
    want = jl.attention_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.int32(cache_len))
    fd_kernel.reset_launches()
    got = tl.attention_decode(_t(q), _t(k), _t(v), torch.tensor(cache_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    assert fd_kernel.LAUNCHES["flash_decode"] == 0  # the CPU runs the plain body


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "mlp"])
def test_mlp_apply_matches_jax(mlp_type):
    rng = np.random.default_rng(4)
    d, f = 48, 96
    params = {"w_in": _np(rng, d, f, scale=d ** -0.5),
              "w_out": _np(rng, f, d, scale=f ** -0.5)}
    if mlp_type != "mlp":
        params["w_gate"] = _np(rng, d, f, scale=d ** -0.5)
    x = _np(rng, 2, 7, d)
    want = jl.mlp_apply({n: jnp.asarray(a) for n, a in params.items()},
                        jnp.asarray(x), mlp_type)
    got = tl.mlp_apply({n: _t(a) for n, a in params.items()}, _t(x), mlp_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    init = tl.mlp_init(torch.Generator().manual_seed(0), d, f, mlp_type,
                       torch.float32)
    assert {n: tuple(t.shape) for n, t in init.items()} == {
        n: a.shape for n, a in params.items()}


# --------------------------------------------------------------------------- #
# the decode-attention kernel's plain version
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize(
    "B,H,KV,D,S,L",
    [(2, 8, 2, 64, 1024, 700), (1, 4, 4, 32, 512, 512), (3, 9, 3, 16, 2048, 1),
     (2, 2, 1, 128, 1024, 999)],  # test_kernels.py's shapes, MQA last
)
def test_decode_ref_matches_pallas(B, H, KV, D, S, L):
    rng = np.random.default_rng(B * 100 + H)
    q, k, v = _np(rng, B, H, D), _np(rng, B, S, KV, D), _np(rng, B, S, KV, D)
    want = decode_attention_pallas(*map(jnp.asarray, (q, k, v)), jnp.int32(L))
    got = decode_attention_ref(_t(q), _t(k), _t(v), L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    # the public op and the kernel's wrapper take the plain version on the CPU
    op = fd_ops.decode_attention(_t(q), _t(k), _t(v), torch.tensor(L))
    assert torch.equal(op, got)


@pytest.mark.parametrize("S,L", [(1088, 1), (1088, 700), (1088, 1088), (77, 33)])
def test_decode_ref_any_length_matches_jax_ref(S, L):
    """Lengths the Pallas kernel refuses (S % 512 != 0) against JAX's oracle,
    at the serve shape's heads (H=9, KV=3, D=64)."""
    rng = np.random.default_rng(S + L)
    q, k, v = _np(rng, 2, 9, 64), _np(rng, 2, S, 3, 64), _np(rng, 2, S, 3, 64)
    want = j_decode_ref(*map(jnp.asarray, (q, k, v)), jnp.int32(L))
    got = fd_ops.decode_attention(_t(q), _t(k), _t(v), L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


def _split_k_decode(q, k, v, L, drop_last=False):
    """The decode kernel's arithmetic in plain torch: f32 scores, chunks of
    ``decode_chunk(B, KV, S, G)`` rows, each an online softmax over 16-row
    steps (running max, p = exp(s - running max) summed unrounded and
    rounded to q's dtype before the value product, earlier sums rescaled),
    chunks merged at their max (the kernel folds 16 chunks at a time), the
    output rounded to q's dtype. ``drop_last`` leaves the last chunk out."""
    B, S, KV, D = k.shape
    G = q.shape[1] // KV
    chunk = fd_kernel.decode_chunk(B, KV, S, G)
    qf = q.float().reshape(B, KV, G, D)
    kf, vf = k.float()[:, :L], v.float()[:, :L]
    s = torch.einsum("bcgd,bscd->bcgs", qf, kf) / np.sqrt(D)
    n_chunks = -(-L // chunk) - (1 if drop_last else 0)
    ms, ls, os = [], [], []
    for c in range(n_chunks):
        m = torch.full(s.shape[:3] + (1,), -1e30)
        l = torch.zeros_like(m)
        o = torch.zeros(s.shape[:3] + (v.shape[3],))
        for r0 in range(c * chunk, min((c + 1) * chunk, L), 16):
            st = s[..., r0:min(r0 + 16, (c + 1) * chunk, L)]
            m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(st - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            o = o * corr + torch.einsum("bcgs,bscd->bcgd", p.to(q.dtype).float(),
                                        vf[:, r0:r0 + st.shape[-1]])
            m = m_new
        ms.append(m)
        ls.append(l)
        os.append(o)
    M = torch.stack(ms).amax(dim=0)
    w = [torch.exp(m - M) for m in ms]
    num = sum(o * wc for o, wc in zip(os, w, strict=True))
    den = sum(lc * wc for lc, wc in zip(ls, w, strict=True))
    return (num / den).reshape(B, KV * G, -1).to(q.dtype)


@pytest.mark.parametrize("B,H,KV,D,S,L", [(8, 9, 3, 64, 1088, 1088),
                                          (8, 9, 3, 64, 1088, 700),
                                          (3, 4, 2, 32, 77, 41),
                                          (2, 48, 1, 128, 512, 512)])
def test_decode_bound_holds_the_kernel_rounding_and_catches_faults(B, H, KV, D, S, L):
    """``decode_attention_bound`` in bf16 (the card's check of the kernel)
    holds the kernel's split-K rounding at the serve shape, a short cache
    and a large group, and rejects a dropped chunk and swapped row halves."""
    from repro_torch.kernels.flash_decode.ref import decode_attention_bound

    rng = np.random.default_rng(S + L + H)
    q, k, v = (_t(_np(rng, *shp)).bfloat16()
               for shp in ((B, H, D), (B, S, KV, D), (B, S, KV, D)))
    want, bound = decode_attention_bound(q, k, v, L)
    assert ((_split_k_decode(q, k, v, L).float() - want).abs() <= bound).all()
    swapped = torch.cat([v[..., D // 2:], v[..., :D // 2]], dim=-1)
    faults = [torch.cat([_split_k_decode(q, k, swapped, L)[..., :D // 2],
                         _split_k_decode(q, k, v, L)[..., D // 2:]], dim=-1)]
    if L > fd_kernel.decode_chunk(B, KV, S, H // KV):
        faults.append(_split_k_decode(q, k, v, L, drop_last=True))
    for bad in faults:
        assert ((bad.float() - want).abs() > bound).any()


#: the dense configs' decode shapes on the card (B=8; SmolLM at its serve
#: length, the others at 4096 rows): B, KV, S, G
DECODE_SHAPES = [(8, 3, 1088, 3), (8, 32, 4096, 1), (8, 16, 4096, 1),
                 (8, 1, 4096, 48)]


@pytest.mark.parametrize("B,KV,S,G", DECODE_SHAPES + [(3, 2, 77, 2), (1, 1, 5, 1),
                                                      (64, 64, 100000, 4),
                                                      (1, 1, 4096, 100)])
def test_decode_chunk_is_a_fixed_split_of_two_waves(B, KV, S, G):
    """The split-K chunk is a pure function of (B, KV, S, G): at least 16
    rows and a multiple of 16, its chunks cover S, and at the dense configs'
    shapes the tensor-core grid (a block per 16-head tile and chunk) makes
    at least two waves on the card's 132 SMs."""
    chunk = fd_kernel.decode_chunk(B, KV, S, G)
    assert chunk == fd_kernel.decode_chunk(B, KV, S, G)
    assert chunk >= 16 and chunk % 16 == 0
    n_chunks = -(-S // chunk)
    assert n_chunks * chunk >= S > (n_chunks - 1) * chunk
    if (B, KV, S, G) in DECODE_SHAPES:
        assert B * KV * -(-G // 16) * n_chunks >= 2 * fd_kernel.SMS


def test_decode_wrapper_checks_inputs():
    rng = np.random.default_rng(0)
    q, k, v = _t(_np(rng, 2, 6, 64)), _t(_np(rng, 2, 40, 2, 64)), _t(
        _np(rng, 2, 40, 2, 64))
    n = torch.tensor([17], dtype=torch.int32)
    fd_kernel.reset_launches()
    fd_kernel.flash_decode(q, k, v, n)  # the plain version: no launch counted
    assert fd_kernel.LAUNCHES["flash_decode"] == 0
    # a view of a longer cache is read where it lies
    big = _t(_np(rng, 2, 64, 2, 64))
    torch.testing.assert_close(fd_kernel.flash_decode(q, big[:, :40], v, n),
                               decode_attention_ref(q, big[:, :40], v, 17))
    bad = [
        (TypeError, (q.double(), k.double(), v.double(), n)),  # dtype
        (TypeError, (q, k.bfloat16(), v, n)),  # mixed dtypes
        (TypeError, (q, k, v, n.long())),  # cache_len type
        (ValueError, (q[:, :5], k, v, n)),  # 5 heads over 2 KV heads
        (ValueError, (q[..., :60].contiguous(), k[..., :60].contiguous(),
                      v[..., :60].contiguous(), n)),  # D not a multiple of 8
        (ValueError, (q, k.transpose(1, 2).contiguous().transpose(1, 2), v,
                      n)),  # heads not packed in a row
        (ValueError, (q.transpose(0, 1).contiguous().transpose(0, 1), k, v,
                      n)),  # q not contiguous
        (ValueError, (q, k.to("meta"), v, n)),  # wrong device
    ]
    for exc, args in bad:
        with pytest.raises(exc):
            fd_kernel.flash_decode(*args)


# --------------------------------------------------------------------------- #
# whole models, reduced, float32
# --------------------------------------------------------------------------- #
def _jax_and_port(name, seed=0):
    jcfg = j_get_arch(name).reduced()
    params = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    model = tm.transformer_params_from_jax(np_params, get_arch(name).reduced(),
                                           "cpu")
    return jcfg, params, np_params, model


def _jax_embed(dst, src):
    """``examples/serve_transformer.py``'s copy of the prefill caches into
    the decode-length caches."""
    if dst.shape == src.shape:
        return src.astype(dst.dtype)
    axis = [i for i, (a, b) in enumerate(zip(dst.shape, src.shape)) if a != b][0]
    return jax.lax.dynamic_update_slice_in_dim(dst, src.astype(dst.dtype), 0,
                                               axis=axis)


@pytest.mark.parametrize("name", DENSE)
def test_reduced_prefill_and_decode_match_jax(name):
    jcfg, params, _, model = _jax_and_port(name)
    B, S, T = 2, 12, 4
    prompts = np.random.default_rng(5).integers(0, jcfg.vocab_size, (B, S))
    j_logits, j_pre = jax.jit(jm.make_prefill_step(jcfg))(
        params, {"tokens": jnp.asarray(prompts, jnp.int32)})
    with torch.no_grad():
        t_logits, t_pre = tm.make_prefill_step(model.cfg)(model, _t(prompts))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **MODEL_TOL)
    for i, c in enumerate(t_pre):
        for n in ("k", "v"):
            np.testing.assert_allclose(c[n].numpy(), np.asarray(j_pre["scan"][n][i]),
                                       **MODEL_TOL)
    j_caches = jax.tree_util.tree_map(_jax_embed, jm.init_caches(jcfg, B, S + T),
                                      j_pre)
    t_caches = tm.init_caches(model.cfg, B, S + T, "cpu")
    for c, p in zip(t_caches, t_pre):
        for n in ("k", "v"):
            c[n][:, :S] = p[n]
    j_decode = jax.jit(jm.make_decode_step(jcfg))
    t_decode = tm.make_decode_step(model.cfg)
    j_tok = jnp.argmax(j_logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    t_tok = t_logits[:, -1].argmax(-1)[:, None]
    for t in range(T):
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
        j_logits, j_caches = j_decode(params, {"tokens": j_tok}, jnp.int32(S + t),
                                      j_caches)
        with torch.no_grad():
            t_logits, t_caches = t_decode(model, t_tok, torch.tensor(S + t),
                                          t_caches)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   **MODEL_TOL)
        j_tok = jnp.argmax(j_logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        t_tok = t_logits[:, -1].argmax(-1)[:, None]
    for i, c in enumerate(t_caches):  # the in-place writes hold what JAX's hold
        np.testing.assert_allclose(c["k"].numpy(), np.asarray(j_caches["scan"]["k"][i]),
                                   **MODEL_TOL)


def test_teacher_forced_decode_equals_prefill():
    """Inside the port: prefill over S tokens then 4 teacher-forced decode
    steps give the logits of a prefill over S + 4 tokens (1e-4: the same
    function, another order of sums)."""
    cfg = ArchConfig(name="t", family="dense", num_layers=2, d_model=64,
                     vocab_size=97, num_heads=4, num_kv_heads=2, head_dim=16,
                     d_ff=64, dtype="float32")
    model = tm.init_params(cfg, torch.Generator().manual_seed(0))
    B, S = 2, 8
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 97, (B, S + 4)))
    with torch.no_grad():
        full, _ = tm.forward(model, toks)
        last, pre = tm.make_prefill_step(cfg)(model, toks[:, :S])
        torch.testing.assert_close(last[:, 0], full[:, S - 1], **MODEL_TOL)
        caches = tm.init_caches(cfg, B, S + 4, "cpu")
        for c, p in zip(caches, pre):
            for n in ("k", "v"):
                c[n][:, :S] = p[n]
        decode = tm.make_decode_step(cfg)
        for t in range(4):
            logits, caches = decode(model, toks[:, S + t:S + t + 1], S + t, caches)
            torch.testing.assert_close(logits[:, 0], full[:, S + t], **MODEL_TOL)


def test_params_from_jax_checks_names_and_shapes():
    jcfg, _, np_params, model = _jax_and_port("gemma-7b")
    assert model.lm_head is None  # tied
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(np_params))
    cfg = model.cfg
    bad = dict(np_params, lm_head=np_params["embed"].T)
    with pytest.raises(ValueError, match="names"):
        tm.transformer_params_from_jax(bad, cfg, "cpu")
    blocks = dict(np_params["blocks"], attn=dict(np_params["blocks"]["attn"]))
    blocks["attn"]["wq"] = blocks["attn"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="shape"):
        tm.transformer_params_from_jax(dict(np_params, blocks=blocks), cfg, "cpu")
    blocks = dict(np_params["blocks"], mlp=dict(np_params["blocks"]["mlp"]))
    del blocks["mlp"]["w_gate"]
    with pytest.raises(ValueError, match="block parameters"):
        tm.transformer_params_from_jax(dict(np_params, blocks=blocks), cfg, "cpu")
    with pytest.raises(ValueError, match="layers"):
        tm.transformer_params_from_jax(
            dict(np_params, blocks=jax.tree_util.tree_map(lambda a: a[:1],
                                                          np_params["blocks"])),
            cfg, "cpu")


def test_params_from_jax_carries_bfloat16_bitwise():
    """The full configs are bfloat16: their numpy arrays (``ml_dtypes``)
    come over bit for bit, the norms as float32."""
    jcfg = j_get_arch("granite-20b").reduced(dtype="bfloat16")
    np_params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(1), jcfg))
    model = tm.transformer_params_from_jax(
        np_params, get_arch("granite-20b").reduced(dtype="bfloat16"), "cpu")
    assert model.embed.dtype == torch.bfloat16
    assert model.blocks[1].ln2.dtype == torch.float32
    np.testing.assert_array_equal(model.lm_head.detach().view(torch.int16).numpy(),
                                  np_params["lm_head"].view(np.int16))
    np.testing.assert_array_equal(
        model.blocks[1].mlp["w_out"].detach().view(torch.int16).numpy(),
        np_params["blocks"]["mlp"]["w_out"][1].view(np.int16))


# --------------------------------------------------------------------------- #
# the serve entry point
# --------------------------------------------------------------------------- #
def test_serve_generates_jax_greedy_tokens():
    """``repro_torch.serve.generate`` from the JAX weights yields the greedy
    tokens of ``examples/serve_transformer.py``'s loop (reduced SmolLM)."""
    jcfg, params, _, model = _jax_and_port("smollm-135m")
    B, S, new = 2, 16, 8
    prompts = serve.make_prompts(model.cfg, B, S, seed=0)
    # the example's loop
    logits, pre = jax.jit(jm.make_prefill_step(jcfg))(
        params, {"tokens": jnp.asarray(prompts, jnp.int32)})
    caches = jax.tree_util.tree_map(_jax_embed, jm.init_caches(jcfg, B, S + new),
                                    pre)
    decode = jax.jit(jm.make_decode_step(jcfg))
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32).reshape(B, 1)
    want = [tok]
    for t in range(new - 1):
        logits, caches = decode(params, {"tokens": tok}, jnp.int32(S + t), caches)
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32).reshape(B, 1)
        want.append(tok)
    out = serve.generate(model, torch.as_tensor(prompts), new)
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  np.asarray(jnp.concatenate(want, axis=1)))
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(logits[:, -1]),
                               **MODEL_TOL)
    assert len(out["step_ms"]) == new - 1


def test_serve_cli_on_cpu(capsys):
    out = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "16", "--new-tokens", "5"])
    assert out["tokens"].shape == (2, 5)
    assert torch.isfinite(out["logits"]).all()
    text = capsys.readouterr().out
    assert "prefill: 2x16 tokens" in text and "tokens/s" in text


def test_serve_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--reduced", "--batch", "1", "--prompt-len", "4",
                    "--new-tokens", "2"])
