"""Mixture-of-Experts layer in torch (DeepSeek-V2 style: shared + routed
top-k) — the counterpart of ``repro/models/transformer/moe.py``.

Routing is the JAX package's capacity-bounded sorted dispatch: tokens are
sorted by expert (a stable sort, as ``jnp.argsort`` is), the first C of
each expert's group are scattered into an (E, C) buffer (the rest into a
trash slot that is dropped), each expert's gated MLP runs as one batched
product over its C rows, and the results are combined back with the
renormalised top-k weights. Dropped tokens keep the shared experts and the
residual path.

The combine runs without atomics, so a run repeats bit for bit on the card:
the sort is inverted and each token's K rows are summed in a fixed order,
the order of the reference's ``segment_sum`` over the sorted rows (ascending
expert id within a token). The auxiliary loss's per-expert load is a sum
over a dense (T, E) matrix for the same reason. The combine's gathers are
written so that their adjoints accumulate no long run of one row (each
slot's result is copied to its row, the token's rows are a permutation),
which torch's indexing adjoint would add one after another.

The expert-parallel dispatch (``moe_apply_shard_map``, ``opt_moe_shard_map``)
runs on a mesh only and has no single-card counterpart: such a config
raises. ``opt_moe_shard_hints`` is a no-op off a mesh, as in JAX.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.transformer.layers import _normal, mlp_apply, mlp_init


def check_moe(cfg) -> None:
    """Raise ``ValueError`` on ``opt_moe_shard_map``, which needs a mesh."""
    if cfg.opt_moe_shard_map:
        raise ValueError(
            f"{cfg.name}: opt_moe_shard_map=True selects the expert-parallel "
            "shard_map dispatch, which runs on a mesh and has no single-card "
            "counterpart in the port"
        )


def moe_init(generator: torch.Generator, cfg, dtype) -> dict:
    d, dff = cfg.d_model, cfg.moe_d_ff
    E = cfg.num_experts
    p = {
        "router": _normal((d, E), torch.float32, d, generator),
        "w_in": _normal((E, d, dff), dtype, d, generator),
        "w_out": _normal((E, dff, d), dtype, dff, generator),
    }
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = _normal((E, d, dff), dtype, d, generator)
    if cfg.num_shared_experts:
        p["shared"] = mlp_init(generator, d, dff * cfg.num_shared_experts,
                               cfg.mlp_type, dtype)
    return p


def moe_capacity(cfg, tokens: int) -> int:
    """Rows per expert: ``ceil(T*K/E * capacity_factor)``, at least 8 and
    rounded up to a multiple of 8, as the JAX package computes it."""
    C = int(math.ceil(tokens * cfg.moe_top_k / cfg.num_experts
                      * cfg.moe_capacity_factor))
    return max(8, ((C + 7) // 8) * 8)


def moe_apply(params, x: torch.Tensor, cfg):
    """x: (B, S, d) -> (out (B, S, d), aux_loss ()) float32 aux."""
    check_moe(cfg)
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.moe_top_k
    T = B * S
    xt = x.reshape(T, d)

    gates = torch.softmax(xt.float() @ params["router"], dim=-1)  # (T, E)
    topw, tope = torch.topk(gates, K, dim=-1)  # (T, K), descending
    topw = topw / topw.sum(dim=-1, keepdim=True).clamp(min=1e-9)

    # ---- capacity-bounded sorted dispatch --------------------------------
    C = moe_capacity(cfg, T)
    flat_e = tope.reshape(-1)  # (T*K,)
    flat_w = topw.reshape(-1)
    order = torch.argsort(flat_e, stable=True)  # group by expert
    e_sorted = flat_e[order]
    t_sorted = order // K  # flat index t*K + k -> token t
    w_sorted = flat_w[order]
    # rank within the expert's group
    starts = torch.searchsorted(e_sorted, torch.arange(E, device=x.device))
    rank = torch.arange(T * K, device=x.device) - starts[e_sorted]
    slot = torch.where(rank < C, e_sorted * C + rank, E * C)  # overflow -> trash

    buf = x.new_zeros((E * C + 1, d))
    xe = buf.index_copy_(0, slot, xt[t_sorted])[:-1].reshape(E, C, d)

    # ---- expert compute: one batched product per weight --------------------
    if cfg.mlp_type in ("swiglu", "geglu"):
        g = torch.bmm(xe, params["w_gate"])
        gate = F.silu(g) if cfg.mlp_type == "swiglu" else F.gelu(g, approximate="tanh")
        hidden = gate * torch.bmm(xe, params["w_in"])
    else:
        hidden = F.gelu(torch.bmm(xe, params["w_in"]), approximate="tanh")
    ye = torch.bmm(hidden, params["w_out"])  # (E, C, d)

    # ---- combine, in a fixed order ------------------------------------------
    # each slot's result is copied to its sorted row (a dropped row stays 0,
    # an unfilled slot goes to a trash row): the reference's gather by slot
    # has an adjoint that adds every dropped row into one trash slot, one
    # after another; this copy's adjoint is a gather
    ar = torch.arange(T * K, device=x.device)
    row_of_slot = torch.full((E * C + 1,), T * K, dtype=ar.dtype,
                             device=x.device).scatter_(0, slot, ar)[:-1]
    y_rows = x.new_zeros((T * K + 1, d)).index_copy_(
        0, row_of_slot, ye.reshape(E * C, d))[:-1]
    y_tok = y_rows * w_sorted[:, None].to(x.dtype)  # (T*K, d), sorted
    # each token's K rows by their place in the sorted order: a permutation
    # of the rows, gathered once and summed in order
    inv = torch.empty_like(order).scatter_(0, order, ar)
    rows = inv.reshape(T, K).sort(dim=1).values
    y_k = y_tok[rows.reshape(-1)].reshape(T, K, d).unbind(dim=1)
    out = y_k[0]
    for k in range(1, K):
        out = out + y_k[k]

    if cfg.num_shared_experts:
        out = out + mlp_apply(params["shared"], xt, cfg.mlp_type)

    # Switch-style load-balance aux loss
    me = gates.mean(dim=0)  # (E,)
    ce = torch.zeros((T, E), dtype=torch.float32, device=x.device).scatter_(
        1, tope, topw).sum(dim=0) / T
    aux = (me * ce).sum() * E
    return out.reshape(B, S, d), aux
