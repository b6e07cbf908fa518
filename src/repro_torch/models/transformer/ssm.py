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

On a (data, model) mesh (``launch/mesh.py``) a rank holds ``in_proj`` by
the reference's spec: (None, "model") in contiguous column blocks where the
model axis divides its columns, which then cut through z/x/B/C/dt
(Mamba2's 10576 columns, 661 a rank at M = 16), else whole (Hymba's 6482
at M = 4 or 16). So the projection is computed from the rank's columns and
gathered over ``model`` (a counted collective), or from the whole leaf.
The rank then takes its block of heads where M divides H (the SSM
``state`` is sharded so by ``cache_specs``), or every head where it does
not; ``out_proj`` (rows over ``model``) is row-parallel
(``layers.row_parallel``: the rank's heads, or its block of every head's
output, summed over ``model``). The gated RMSNorm averages over the whole
``d_inner``: with the rank's heads only, the sum of squares is summed over
``model``. In train mode the branch is a partial region of ``model``
(``mesh.enter``): the replicated input (or, with a whole ``in_proj``, its
projection) and ``A_log``/``D``/``dt_bias``/``norm_scale`` enter it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import all_gather, all_reduce, enter
from repro_torch.launch.sharding import model_dim
from repro_torch.models.transformer.layers import init_tree, row_parallel


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


def _rank_heads(params, cfg, mesh) -> tuple[int, int]:
    """(first head, heads) that a rank computes: every head off a mesh,
    with a whole ``out_proj``, or where the model axis does not divide the
    heads; else its own block of H / M."""
    H = cfg.ssm_nheads
    if model_dim(params["out_proj"]) is None or H % mesh.model_size:
        return 0, H
    nh = H // mesh.model_size
    return mesh.model_index * nh, nh


def _project(params, x, mesh):
    """``x @ in_proj``, every column: from the rank's column block gathered
    over ``model`` where the leaf is sharded (``x`` entering the product,
    the gather feeding a partial region where ``out_proj`` is sharded),
    else from the whole leaf (the projection entering the partial region,
    if there is one, so that the whole leaf's gradient is summed)."""
    w = params["in_proj"]
    partial = model_dim(params["out_proj"]) is not None
    if model_dim(w) is not None:
        return all_gather(enter(x, mesh=mesh) @ w, mesh, dim=-1,
                          partial=partial)
    proj = x @ w
    return enter(proj, mesh=mesh) if partial else proj


def _rank_parts(params, proj, cfg, mesh):
    """(z, x, B, C, dt, leaves, (h0, nh)) of the projection for the heads
    [h0, h0 + nh) that the rank computes (``_rank_heads``): z, x and dt and
    the leaves ``A_log``/``D``/``dt_bias``/``norm_scale`` narrowed to them
    (entering the partial region where ``out_proj`` is sharded); B and C
    whole (their groups serve every head)."""
    z, xs, Bm, Cm, dt = _split_proj(proj, cfg)
    names = ("A_log", "D", "dt_bias", "norm_scale")
    leaves = [params[n] for n in names]
    if model_dim(params["out_proj"]) is not None:
        leaves = list(enter(*leaves, mesh=mesh))
    h0, nh = _rank_heads(params, cfg, mesh)
    if nh != cfg.ssm_nheads:
        P = cfg.ssm_headdim
        z, xs = (t[..., h0 * P:(h0 + nh) * P] for t in (z, xs))
        dt = dt[..., h0:h0 + nh]
        leaves = [t[h0:h0 + nh] for t in leaves[:3]] + [
            leaves[3][h0 * P:(h0 + nh) * P]]
    return z, xs, Bm, Cm, dt, dict(zip(names, leaves)), (h0, nh)


def _group_heads(t, cfg, dim: int, heads: tuple):
    """B or C (..., G, N) broadcast from its groups to every head along
    ``dim``, then narrowed to ``heads`` (h0, nh)."""
    t = t.repeat_interleave(cfg.ssm_nheads // cfg.ssm_ngroups, dim=dim)
    h0, nh = heads
    return t if nh == cfg.ssm_nheads else t.narrow(dim, h0, nh)


def _gated_norm_out(params, leaves, y: torch.Tensor, z: torch.Tensor, dtype,
                    cfg, mesh, heads: tuple):
    """Mamba-2's gated RMSNorm before ``out_proj``, in float32: ``y`` and
    ``z`` of the heads ``heads`` (h0, nh), whose scale ``leaves`` hold.
    With fewer than every head the sum of squares over ``d_inner`` is
    summed over ``model`` (replicated, but each rank's part of its gradient
    is partial: it enters the partial region again)."""
    nh = heads[1]
    if nh == cfg.ssm_nheads:
        var = y.square().mean(dim=-1, keepdim=True)
    else:
        var = enter(all_reduce(y.square().sum(dim=-1, keepdim=True), mesh),
                    mesh=mesh) / cfg.d_inner
    y = y * torch.rsqrt(var + 1e-6) * leaves["norm_scale"]
    y = y * F.silu(z.float())
    return row_parallel(y.to(dtype), nh, cfg.ssm_nheads, params["out_proj"],
                        mesh).to(dtype)


def _final_state(xs, Bm, dt, leaves, cfg, heads):
    """The SSM state after a full sequence from the projection's parts of
    the heads ``heads``: state = sum_t exp(sum_{t'>t} dA_t') * dt_t * B_t
    x_t^T, (B, nh, N, P) float32."""
    Bsz, S = xs.shape[:2]
    nh = heads[1]
    xs = xs.reshape(Bsz, S, nh, cfg.ssm_headdim).float()
    Bh = _group_heads(Bm.reshape(Bsz, S, cfg.ssm_ngroups, cfg.ssm_state), cfg,
                      2, heads).float()
    A = -torch.exp(leaves["A_log"])
    dt = F.softplus(dt.float() + leaves["dt_bias"])
    dA = dt * A  # (B, S, nh)
    # suffix sums of dA, excluding t
    tail = torch.flip(torch.cumsum(torch.flip(dA, [1]), dim=1), [1]) - dA
    w = torch.exp(tail)  # (B, S, nh)
    return torch.einsum("bshn,bshp->bhnp", Bh * w[..., None],
                        xs * dt[..., None])


def ssd_final_state(params, h, cfg):
    """The final SSM state of ``h`` (B, S, d) through the layer (every
    head, one rank): the prefill -> decode handoff, (B, H, N, P)."""
    _, xs, Bm, _, dt = _split_proj(h @ params["in_proj"], cfg)
    return _final_state(xs, Bm, dt, params, cfg, (0, cfg.ssm_nheads))


def ssm_apply_train(params, x: torch.Tensor, cfg, mesh=None,
                    final_state: bool = False):
    """Chunked SSD forward, for prefill and train alike. x: (B, S, d) ->
    (B, S, d); S must be a multiple of ``cfg.ssm_chunk``. With
    ``final_state`` -> (out, the state after the sequence, (B, nh, N, P):
    the rank's heads), for the decode that follows a prefill.

    Every op is out of place, so autograd can differentiate it (an in-place
    ``exp_``/``masked_fill_``/``mul_`` would overwrite the exponentials the
    backward needs). Without autograd (serve, under ``inference_mode``) the
    (B, chunks, Q, Q, H) float32 intra-chunk tensors are still freed as soon
    as they are used; at most one more of them is alive at a time. On a
    rank of ``mesh`` the heads are the rank's (module docstring)."""
    Bsz, S, _ = x.shape
    P, N, G = cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups
    Q = cfg.ssm_chunk
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the SSM chunk {Q}")
    nc = S // Q

    proj = _project(params, x, mesh)  # (B, S, proj)
    z, xs, Bm, Cm, dt_raw, leaves, heads = _rank_parts(params, proj, cfg, mesh)
    H = heads[1]
    xs = xs.reshape(Bsz, S, H, P)
    # broadcast groups over heads
    Bh = _group_heads(Bm.reshape(Bsz, S, G, N).float(), cfg, 2, heads)
    Ch = _group_heads(Cm.reshape(Bsz, S, G, N).float(), cfg, 2, heads)

    A = -torch.exp(leaves["A_log"])  # (H,) negative
    dt = F.softplus(dt_raw.float() + leaves["dt_bias"])  # (B, S, H)
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
    y = y + leaves["D"][None, None, :, None] * xs.float()
    out = _gated_norm_out(params, leaves, y.reshape(Bsz, S, H * P), z, x.dtype,
                          cfg, mesh, heads)
    if not final_state:
        return out
    return out, _final_state(xs, Bm, dt_raw, leaves, cfg, heads)


def ssm_apply_decode(params, x: torch.Tensor, state: torch.Tensor, cfg,
                     mesh=None):
    """One-token recurrent step. x: (B, 1, d); state: (B, H, N, P) float32
    (on a rank of ``mesh``, its heads' (B, nh, N, P)), **updated in place**
    and returned: (out (B, 1, d), state)."""
    Bsz = x.shape[0]
    P, N, G = cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups
    proj = _project(params, x[:, 0], mesh)  # (B, proj)
    z, xs, Bm, Cm, dt, leaves, heads = _rank_parts(params, proj, cfg, mesh)
    H = heads[1]
    xs = xs.reshape(Bsz, H, P).float()
    Bh = _group_heads(Bm.reshape(Bsz, G, N), cfg, 1, heads).float()
    Ch = _group_heads(Cm.reshape(Bsz, G, N), cfg, 1, heads).float()
    A = -torch.exp(leaves["A_log"])
    dt = F.softplus(dt.float() + leaves["dt_bias"])  # (B, H)
    decay = torch.exp(dt * A)  # (B, H)
    # h_t = decay * h_{t-1} + dt * B ⊗ x
    state.mul_(decay[:, :, None, None]).add_(
        torch.einsum("bhn,bhp->bhnp", Bh, xs * dt[..., None]))
    y = torch.einsum("bhn,bhnp->bhp", Ch, state)  # (B, H, P)
    y = y + leaves["D"][None, :, None] * xs
    out = _gated_norm_out(params, leaves, y.reshape(Bsz, H * P), z, x.dtype,
                          cfg, mesh, heads)
    return out[:, None, :], state
