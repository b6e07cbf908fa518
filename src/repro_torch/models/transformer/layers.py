"""Transformer building blocks in torch — the counterpart of
``repro/models/transformer/layers.py``: RMSNorm, RoPE, attention (full,
chunked-flash, single-token decode; GQA, and MLA's D != Dv) and the MLPs.

The JAX package's casts are kept exactly: norms and RoPE compute in float32
and cast back to the input dtype; attention scores and softmax are float32,
the probabilities are cast to the query dtype before the value product; the
MLP casts its result back to the input dtype. Layouts are the JAX package's:
activations (B, S, H, D), caches (B, S, KV, D).

``attention_decode`` is where the decode-attention kernel enters the model:
it calls ``kernels/flash_decode/ops.decode_attention``, which launches the
hand-written CUDA kernel on a CUDA tensor (or raises) and runs its plain
version on a CPU tensor. ``attention_decode_seq`` is the decode against a
cache sharded by sequence over a mesh's model axis: the kernel's partial
output on each rank's rows, merged across the ranks.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_decode import ops as flash_decode_ops
from repro_torch.kernels.flash_decode.ref import merge_partials
from repro_torch.launch.mesh import all_gather, all_reduce
from repro_torch.launch.sharding import model_dim

#: the masked-score fill of the JAX package (finite: an all-masked row gives
#: a uniform softmax, never NaN)
MASK_VALUE = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """The inverse frequencies in float64, as the JAX package has them (the
    reference ``_rope_freqs_on`` is tested against)."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


def _rope_freqs_on(head_dim: int, theta: float, device) -> torch.Tensor:
    """``rope_freqs`` computed on ``device`` (float64, then float32): a copy
    of the numpy table from the host would be a pageable upload, which waits
    for the device on every call."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64, device=device) / head_dim
    return (1.0 / theta ** exps).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: broadcastable to (..., S).
    Rotates the two halves of D (not interleaved pairs), in float32."""
    D = x.shape[-1]
    freqs = _rope_freqs_on(D, theta, x.device)  # (D/2,)
    angles = positions[..., :, None].float() * freqs  # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# Attention cores
# --------------------------------------------------------------------------- #
def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, KV*groups, D) for GQA."""
    if groups == 1:
        return k
    return k.repeat_interleave(groups, dim=2)


def attention_full(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,  # (B, S, KV, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Materialized-scores attention (prefill below ``FLASH_THRESHOLD``)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    k = _repeat_kv(k, H // KV)
    v = _repeat_kv(v, H // KV)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (1.0 / np.sqrt(D))
    q_pos = torch.arange(Sq, device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    scores = torch.where(mask, scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _block_mask(qi, kj, chunk, window, device):
    """Block (query chunk qi, key chunk kj)'s (chunk, chunk) mask of the
    scores kept: causal, and (windowed) within ``window``."""
    ar = torch.arange(chunk, device=device)
    q_pos = qi * chunk + ar
    k_pos = kj * chunk + ar
    msk = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        msk &= q_pos[:, None] - k_pos[None, :] < window
    return msk


def _block_dead(qi: int, kj: int, chunk: int, window: int | None) -> bool:
    """Whether every score of block (qi, kj) is masked."""
    return kj > qi or (window is not None and (qi - kj - 1) * chunk + 1 >= window)


def _flash_forward(q, k, v, chunk, window):
    """The chunked online-softmax loop over q (B, S, H, D) and k, v already
    repeated to H heads -> (out (B, S, H, Dv) in q's dtype, each row's
    log-sum-exp (B, H, S) float32).

    Dead blocks are skipped and live ones masked. The output has the
    values of the JAX scan, which visits and masks every block: a dead block
    after the first live one adds p = 0 and scales by exp(0) = 1, and one
    before it is erased by the first live block's correction
    exp(-1e30 - m) = 0."""
    B, S, H, D = q.shape
    Dv = v.shape[3]
    scale = 1.0 / np.sqrt(D)
    nq = S // chunk
    outs, lses = [], []
    for qi in range(nq):
        q_blk = q[:, qi * chunk:(qi + 1) * chunk]
        m = torch.full((B, H, chunk), MASK_VALUE, dtype=torch.float32, device=q.device)
        d = torch.zeros((B, H, chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, chunk, Dv), dtype=torch.float32, device=q.device)
        for kj in range(nq):
            if _block_dead(qi, kj, chunk, window):
                continue
            k_blk = k[:, kj * chunk:(kj + 1) * chunk]
            v_blk = v[:, kj * chunk:(kj + 1) * chunk]
            s = torch.einsum("bqhd,bkhd->bhqk", q_blk, k_blk).float() * scale
            s = torch.where(_block_mask(qi, kj, chunk, window, q.device), s,
                            MASK_VALUE)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            d = d * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(q.dtype), v_blk
            ).float()
            m = m_new
        outs.append((acc / d[..., None].clamp(min=1e-30)).to(q.dtype))
        lses.append(m + torch.log(d))
    out = torch.stack(outs, dim=2)  # (B, H, nq, chunk, Dv)
    return out.reshape(B, H, S, Dv).transpose(1, 2), torch.cat(lses, dim=2)


class _FlashAttention(torch.autograd.Function):
    """``attention_flash`` under autograd: the forward is the loop itself
    (the same bits as without autograd) and keeps q, k, v, the output and
    each row's log-sum-exp; the backward recomputes each live block's probabilities
    p = exp(s - lse) and sums its dq, dk, dv in float32 (dS = p (dP -
    rowsum(dO o))), the exact gradient of the softmax attention. So a
    layer's backward holds one block's (B, H, chunk, chunk) tensors at a
    time, where autograd of the loop would keep every block's scores and
    probabilities (B x H x S^2 x 10 bytes a layer: 43 GB at
    DeepSeek-V2-236B's 128 heads, B = 2, S = 4096)."""

    @staticmethod
    def forward(ctx, q, k, v, chunk, window):
        out, lse = _flash_forward(q, k, v, chunk, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.chunk, ctx.window = chunk, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        chunk, window = ctx.chunk, ctx.window
        dt = q.dtype
        S, D = q.shape[1], q.shape[3]
        scale = 1.0 / np.sqrt(D)
        nq = S // chunk
        dout = dout.to(dt)
        delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2)  # (B, H, S)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        for qi in range(nq):
            rows = slice(qi * chunk, (qi + 1) * chunk)
            q_blk, do_blk = q[:, rows], dout[:, rows]
            lse_blk = lse[:, :, rows, None]
            delta_blk = delta[:, :, rows, None]
            for kj in range(nq):
                if _block_dead(qi, kj, chunk, window):
                    continue
                cols = slice(kj * chunk, (kj + 1) * chunk)
                k_blk, v_blk = k[:, cols], v[:, cols]
                s = torch.einsum("bqhd,bkhd->bhqk", q_blk, k_blk).float() * scale
                s = torch.where(_block_mask(qi, kj, chunk, window, q.device),
                                s, MASK_VALUE)
                p = torch.exp(s - lse_blk)
                dv[:, cols] += torch.einsum("bhqk,bqhd->bkhd", p.to(dt),
                                            do_blk).float()
                dp = torch.einsum("bqhd,bkhd->bhqk", do_blk, v_blk).float()
                ds = (p * (dp - delta_blk)).to(dt)
                dq[:, rows] += torch.einsum("bhqk,bkhd->bqhd", ds,
                                            k_blk).float() * scale
                dk[:, cols] += torch.einsum("bhqk,bqhd->bkhd", ds,
                                            q_blk).float() * scale
        return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype), None, None


def attention_flash(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,  # (B, S, KV, Dv)
    *,
    chunk: int = 1024,
    window: int | None = None,
) -> torch.Tensor:
    """Chunked online-softmax causal attention (train and prefill at
    ``FLASH_THRESHOLD`` and above): a plain torch loop over query chunks
    and, inside, over the key chunks holding an unmasked score, with a
    running (max, denominator, accumulator); peak memory O(S * chunk)
    instead of O(S^2). When autograd records (train), ``_FlashAttention``
    runs the same loop and gives it a flash backward."""
    S = q.shape[1]
    H, KV = q.shape[2], k.shape[2]
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {chunk}")
    k = _repeat_kv(k, H // KV)
    v = _repeat_kv(v, H // KV)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, chunk, window)
    return _flash_forward(q, k, v, chunk, window)[0]


def attention_decode(
    q: torch.Tensor,  # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, S, KV, D)
    v_cache: torch.Tensor,  # (B, S, KV, Dv)
    cache_len: torch.Tensor,  # () int — number of valid cache rows, on device
) -> torch.Tensor:
    """Single-token decode against a (possibly ring-buffered) KV cache ->
    (B, 1, H, Dv), masking cache rows at or past ``cache_len``.

    This is ``flash_decode.ops.decode_attention``: on a CUDA tensor the
    hand-written split-K decode kernel (replacing the Pallas
    ``decode_attention_pallas_bkv``), on a CPU tensor its plain version
    ``flash_decode.ref.decode_attention_ref`` (the JAX function's body). A
    ring-buffered cache needs no window mask: it holds only the window.
    """
    return flash_decode_ops.decode_attention(
        q[:, 0], k_cache, v_cache, cache_len)[:, None]


def row_parallel(out, nh: int, n_heads: int, wo, mesh):
    """``out`` (..., nh * width), nh of ``n_heads`` heads (every head, or
    the rank's own block), times ``wo``, in ``out``'s dtype: all of ``out``
    against a whole ``wo`` (every head is then here); the rows of a sharded
    ``wo`` against its columns of ``out`` (its own heads, or its block of
    every head), summed over ``model``."""
    if model_dim(wo) is None:
        return (out @ wo).to(out.dtype)
    if nh == n_heads:
        j, R = mesh.model_index, wo.shape[0]
        out = out[..., j * R:(j + 1) * R]
    return all_reduce((out @ wo).to(out.dtype), mesh)


def merge_over_model(o, m, d, mesh, dtype) -> torch.Tensor:
    """The attention output from each model rank's partial (o (B, H, Dv), m
    and d (B, H), float32; the rank's rows only): one ``all_gather`` of
    (o, m, d) packed as (B, H, Dv + 2) over ``model``, then
    ``merge_partials`` in rank order -> (B, H, Dv) in ``dtype``, the same on
    every rank."""
    packed = torch.cat([o, m[..., None], d[..., None]], dim=-1)
    parts = all_gather(packed[None], mesh, dim=0)  # (M, B, H, Dv + 2)
    return merge_partials(parts[..., :-2], parts[..., -2], parts[..., -1],
                          dtype)


def attention_decode_seq(
    q: torch.Tensor,  # (B, 1, H, D), every head
    k_cache: torch.Tensor,  # (B, S_loc, KV, D): the rank's rows
    v_cache: torch.Tensor,  # (B, S_loc, KV, Dv)
    cache_len: torch.Tensor,  # () int: valid rows of the whole cache
    mesh,
) -> torch.Tensor:
    """``attention_decode`` against a cache sharded by sequence over
    ``mesh``'s model axis: model rank j holds physical rows [j * S_loc,
    (j + 1) * S_loc), of which clamp(cache_len - j * S_loc, 0, S_loc) are
    valid (physical slots, so a ring's too: it fills its slots in order and
    then holds every one). The decode kernel's partial output on the rank's
    rows (``decode_attention_partial``), merged over the model group
    (``merge_over_model``) -> (B, 1, H, Dv) in q's dtype, on every rank.
    A rank with no valid row weighs nothing."""
    S_loc = k_cache.shape[1]
    n = (cache_len - mesh.model_index * S_loc).clamp(0, S_loc)
    o, m, d = flash_decode_ops.decode_attention_partial(q[:, 0], k_cache,
                                                        v_cache, n)
    return merge_over_model(o, m, d, mesh, q.dtype)[:, None]


# --------------------------------------------------------------------------- #
# MLPs
# --------------------------------------------------------------------------- #
MLP_TYPES = ("swiglu", "geglu", "mlp")


def mlp_apply(params, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    if mlp_type == "swiglu":
        gate = F.silu(x @ params["w_gate"])
        return ((gate * (x @ params["w_in"])) @ params["w_out"]).to(x.dtype)
    if mlp_type == "geglu":
        gate = F.gelu(x @ params["w_gate"], approximate="tanh")
        return ((gate * (x @ params["w_in"])) @ params["w_out"]).to(x.dtype)
    if mlp_type == "mlp":
        return (F.gelu(x @ params["w_in"], approximate="tanh")
                @ params["w_out"]).to(x.dtype)
    raise ValueError(mlp_type)


def _normal(shape, dtype, fan_in, generator):
    """``normal * fan_in**-0.5`` in ``dtype``, drawn on the generator's
    device (the JAX package's ``_dense`` init; not its bits), scaled in
    place so that one leaf's worth of memory is alive."""
    t = torch.randn(shape, dtype=dtype, generator=generator,
                    device=generator.device)
    return t.mul_(fan_in ** -0.5)


def leaf_dtype(name: str, shape: tuple, dtype: torch.dtype) -> torch.dtype:
    """A parameter's dtype, as the JAX package's init makes it: float32 for
    the norms' scales, the SSM's per-head vectors and the MoE router."""
    return torch.float32 if len(shape) == 1 or name.split(".")[-1] == "router" \
        else dtype


def init_tree(generator: torch.Generator, shapes: dict, dtype, *,
              fixed: dict | None = None, keep=None, prefix: str = "") -> dict:
    """The leaves of ``shapes`` (nested dicts of name -> shape), made in its
    order on the generator's device as the JAX package's init makes them
    (not its bits): a leaf that ``fixed`` names by its function (shape,
    device) -> tensor; any other 1-D leaf ones in float32 (a norm's scale);
    every other ``_normal`` in ``leaf_dtype``, its ``fan_in`` the width it
    contracts: the second-to-last dimension, the last for an embedding
    table (``embed``). ``keep(name, leaf)``, ``name`` dotted from
    ``prefix``, replaces each leaf as soon as it is made (a rank keeps its
    slice), so that at most one whole leaf is alive at a time."""
    dev = generator.device
    out = {}
    for name, shape in shapes.items():
        path = prefix + name
        if isinstance(shape, dict):
            out[name] = init_tree(generator, shape, dtype, fixed=fixed,
                                  keep=keep, prefix=path + ".")
            continue
        if fixed and name in fixed:
            t = fixed[name](shape, dev)
        elif len(shape) == 1:
            t = torch.ones(shape, dtype=torch.float32, device=dev)
        else:
            fan_in = shape[-1] if name == "embed" else shape[-2]
            t = _normal(shape, leaf_dtype(name, shape, dtype), fan_in, generator)
        out[name] = t if keep is None else keep(path, t)
        del t  # a kept slice's whole leaf goes before the next is made
    return out


def mlp_shapes(d_model: int, d_ff: int, mlp_type: str) -> dict:
    if mlp_type not in MLP_TYPES:
        raise ValueError(mlp_type)
    p = {"w_in": (d_model, d_ff), "w_out": (d_ff, d_model)}
    if mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = (d_model, d_ff)
    return p


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
             mlp_type: str, dtype) -> dict:
    return init_tree(generator, mlp_shapes(d_model, d_ff, mlp_type), dtype)
