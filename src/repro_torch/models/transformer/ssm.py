"""Mamba-2 SSD (state-space duality) layer in torch — the counterpart of
``repro/models/transformer/ssm.py`` [arXiv:2405.21060].

Chunked path (prefill and train): within each chunk the attention-like
dual form, across chunks the recurrent state pass, a Python loop over the
S/chunk chunks (the JAX package's ``lax.scan``). Decode path: the O(1)
recurrent state update, written into the caller's state in place (decode
is never differentiated).

Parameterization (SSD, scalar-identity A per head):
  x -> in_proj -> [z (gate), x, B, C, dt]  with x split into H heads of P dims
  h_t = exp(dt*A) h_{t-1} + dt * B_t (x_t)     (state: (H, N, P))
  y_t = C_t . h_t + D * x_t ;  out = out_proj(y * silu(z))

The JAX package's casts are kept: the projections run in the input dtype,
everything from B, C, dt and the state onward in float32, and the gated
norm's result is cast back before ``out_proj``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.transformer.layers import init_tree


def _log_uniform_a(shape, device) -> torch.Tensor:
    # A in (-exp range); log-uniform in [1, 16] as in the paper
    return torch.as_tensor(np.log(np.random.default_rng(0).uniform(
        1, 16, shape)).astype(np.float32), device=device)


def _dt_bias(shape, device) -> torch.Tensor:
    return torch.as_tensor(np.log(np.expm1(np.random.default_rng(1).uniform(
        1e-3, 0.1, shape))).astype(np.float32), device=device)


#: the SSD's leaves that no generator draws (``init_tree``'s ``fixed``):
#: ``A_log`` and ``dt_bias`` from ``np.random.default_rng(0)`` and ``(1)``,
#: as the JAX package draws them whatever its key, so those two leaves
#: equal the reference's at any seed
SSM_FIXED = {"A_log": _log_uniform_a, "dt_bias": _dt_bias}


def ssm_shapes(cfg) -> dict:
    d, di, H = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
    return {"in_proj": (d, 2 * di + 2 * cfg.ssm_ngroups * cfg.ssm_state + H),
            "out_proj": (di, d), "A_log": (H,), "D": (H,), "dt_bias": (H,),
            "norm_scale": (di,)}


def ssm_init(generator: torch.Generator, cfg, dtype) -> dict:
    """One SSD layer's parameters on the generator's device (``SSM_FIXED``
    for ``A_log`` and ``dt_bias``)."""
    return init_tree(generator, ssm_shapes(cfg), dtype, fixed=SSM_FIXED)


def _split_proj(proj: torch.Tensor, cfg):
    """in_proj's output -> (z, x, B, C, dt) along the last dim."""
    di = cfg.d_inner
    G, N, H = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    return torch.split(proj, [di, di, G * N, G * N, H], dim=-1)


def _gated_norm_out(params, y: torch.Tensor, z: torch.Tensor, dtype):
    """Mamba-2's gated RMSNorm before ``out_proj``, in float32."""
    var = y.square().mean(dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6) * params["norm_scale"]
    y = y * F.silu(z.float())
    return (y.to(dtype) @ params["out_proj"]).to(dtype)


def ssm_apply_train(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Chunked SSD forward, for prefill and train alike. x: (B, S, d) ->
    (B, S, d); S must be a multiple of ``cfg.ssm_chunk``.

    Every op is out of place, so autograd can differentiate it (an in-place
    ``exp_``/``masked_fill_``/``mul_`` would overwrite the exponentials the
    backward needs). Without autograd (serve, under ``inference_mode``) the
    (B, chunks, Q, Q, H) float32 intra-chunk tensors are still freed as soon
    as they are used; at most one more of them is alive at a time."""
    Bsz, S, _ = x.shape
    H, P, N, G = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups
    Q = cfg.ssm_chunk
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the SSM chunk {Q}")
    nc = S // Q

    proj = x @ params["in_proj"]  # (B, S, proj)
    z, xs, Bm, Cm, dt = _split_proj(proj, cfg)
    xs = xs.reshape(Bsz, S, H, P)
    # broadcast groups over heads
    rep = H // G
    Bh = Bm.reshape(Bsz, S, G, N).float().repeat_interleave(rep, dim=2)
    Ch = Cm.reshape(Bsz, S, G, N).float().repeat_interleave(rep, dim=2)

    A = -torch.exp(params["A_log"])  # (H,) negative
    dt = F.softplus(dt.float() + params["dt_bias"])  # (B, S, H)
    dA = dt * A  # (B, S, H) negative increments
    xdt = xs.float() * dt[..., None]  # (B, S, H, P)

    # chunk views
    x_c = xdt.reshape(Bsz, nc, Q, H, P)
    B_c = Bh.reshape(Bsz, nc, Q, H, N)
    C_c = Ch.reshape(Bsz, nc, Q, H, N)
    cum = torch.cumsum(dA.reshape(Bsz, nc, Q, H), dim=2)  # within-chunk
    total = cum[:, :, -1]  # (B, nc, H)

    # ---- intra-chunk (dual / attention-like form) --------------------------
    # decay(i, j) = exp(cum_i - cum_j) for i >= j, else 0. The exponent is
    # masked too: above the diagonal cum_i - cum_j > 0 overflows exp at
    # full width, and exp's adjoint there is 0 * inf = NaN (the reference's
    # single where has that NaN gradient); the values are the same.
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    tri = tri[None, None, :, :, None]
    decay = torch.where(tri, torch.exp(torch.where(
        tri, cum[:, :, :, None, :] - cum[:, :, None, :, :], 0.0)), 0.0)
    scores = torch.einsum("bcihn,bcjhn->bcijh", C_c, B_c) * decay
    del decay
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, x_c)
    del scores

    # ---- inter-chunk state pass --------------------------------------------
    # chunk state contribution: sum_j exp(total - cum_j) B_j x_j^T
    w = torch.exp(total[:, :, None] - cum)  # (B, nc, Q, H)
    state_contrib = torch.einsum("bcjhn,bcjhp->bchnp", B_c * w[..., None], x_c)
    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    before = []  # the state entering each chunk
    for c in range(nc):
        before.append(h)
        h = h * torch.exp(total[:, c])[:, :, None, None] + state_contrib[:, c]
    h_before = torch.stack(before, dim=1)  # (B, nc, H, N, P)
    y_inter = torch.einsum("bcihn,bchnp->bcihp", C_c, h_before) \
        * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    y = y + params["D"][None, None, :, None] * xs.float()
    return _gated_norm_out(params, y.reshape(Bsz, S, H * P), z, x.dtype)


def ssm_apply_decode(params, x: torch.Tensor, state: torch.Tensor, cfg):
    """One-token recurrent step. x: (B, 1, d); state: (B, H, N, P) float32,
    **updated in place** and returned: (out (B, 1, d), state)."""
    Bsz = x.shape[0]
    H, P, N, G = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups
    proj = x[:, 0] @ params["in_proj"]  # (B, proj)
    z, xs, Bm, Cm, dt = _split_proj(proj, cfg)
    xs = xs.reshape(Bsz, H, P).float()
    rep = H // G
    Bh = Bm.reshape(Bsz, G, N).repeat_interleave(rep, dim=1).float()
    Ch = Cm.reshape(Bsz, G, N).repeat_interleave(rep, dim=1).float()
    A = -torch.exp(params["A_log"])
    dt = F.softplus(dt.float() + params["dt_bias"])  # (B, H)
    decay = torch.exp(dt * A)  # (B, H)
    # h_t = decay * h_{t-1} + dt * B ⊗ x
    state.mul_(decay[:, :, None, None]).add_(
        torch.einsum("bhn,bhp->bhnp", Bh, xs * dt[..., None]))
    y = torch.einsum("bhn,bhnp->bhp", Ch, state)  # (B, H, P)
    y = y + params["D"][None, :, None] * xs
    return _gated_norm_out(params, y.reshape(Bsz, H * P), z, x.dtype)[:, None, :], state
