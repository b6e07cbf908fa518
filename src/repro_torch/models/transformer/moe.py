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

On a (data, model) mesh (``launch/mesh.py``) the experts are sharded over
``model``, E/M a rank (``launch/sharding.py``). Two dispatches run there:

* ``moe_apply_shard_map`` (``opt_moe_shard_map``), the reference's
  expert-local dispatch: each (data i, model j) rank routes its own token
  shard to its own E/M experts with a per-shard capacity (from its T_loc
  tokens, so it drops other tokens than the global dispatch once tokens
  drop), and one token-dim ``all_reduce`` over ``model`` combines the
  experts' partial outputs (with the shared experts' row-parallel partial).
  Its aux loss is each data shard's, averaged over the data axes, as the
  reference's. Without a mesh it raises (``check_moe``); where E does not
  divide the model axis it falls back to the next one, as the reference's
  does.
* otherwise the global dispatch, the function the reference's pjit path
  computes: the tokens are gathered over the data axes, routed with the
  global capacity, each rank computes its own experts' slots, and the same
  one ``all_reduce`` combines them; the rank keeps its own rows.

At a (1, 1) mesh the global dispatch is ``moe_apply`` itself, bit for bit.
In train mode the experts' and the shared experts' sums are a partial
region of ``model`` (``launch/mesh.py``): the tokens and the routing
weights enter it (``mesh.enter``), so that the router and everything
before it get the whole gradient. The data-axis gather of the tokens has
a reduce-scatter adjoint, the data-axis sum of the expert-local ``aux`` an
all-reduce one (each data rank's loss is its own term of the mean).
``opt_moe_shard_hints`` is a no-op, as in JAX off a mesh.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import all_gather, all_reduce, enter
from repro_torch.launch.sharding import model_dim
from repro_torch.models.transformer.layers import init_tree, mlp_apply, mlp_shapes


def check_moe(cfg, mesh=None) -> None:
    """Raise ``ValueError`` on ``opt_moe_shard_map`` without a mesh: the
    expert-local dispatch needs a model axis."""
    if cfg.opt_moe_shard_map and mesh is None:
        raise ValueError(
            f"{cfg.name}: opt_moe_shard_map=True selects the expert-local "
            "dispatch, which runs on a (data, model) mesh: pass one"
        )


def moe_shapes(cfg) -> dict:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    p = {"router": (d, E), "w_in": (E, d, f), "w_out": (E, f, d)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = (E, d, f)
    if cfg.num_shared_experts:
        p["shared"] = mlp_shapes(d, f * cfg.num_shared_experts, cfg.mlp_type)
    return p


def moe_init(generator: torch.Generator, cfg, dtype) -> dict:
    return init_tree(generator, moe_shapes(cfg), dtype)


def moe_capacity(cfg, tokens: int) -> int:
    """Rows per expert: ``ceil(T*K/E * capacity_factor)``, at least 8 and
    rounded up to a multiple of 8, as the JAX package computes it."""
    C = int(math.ceil(tokens * cfg.moe_top_k / cfg.num_experts
                      * cfg.moe_capacity_factor))
    return max(8, ((C + 7) // 8) * 8)


def _route(xt, router, K):
    """(gates (T, E) float32, topw (T, K) renormalised, tope (T, K))."""
    gates = torch.softmax(xt.float() @ router, dim=-1)  # (T, E)
    topw, tope = torch.topk(gates, K, dim=-1)  # (T, K), descending
    topw = topw / topw.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return gates, topw, tope


def _dispatch(params, xt, topw, tope, cfg, C: int, e_lo: int = 0):
    """The routed experts' output (T, d) over the experts that ``params``
    hold (E_loc of them, ids from ``e_lo``), C rows each: a token's
    choices of other experts add nothing (with all E, the whole output)."""
    T, d = xt.shape
    K = cfg.moe_top_k
    E_loc = params["w_in"].shape[0]
    flat_e = tope.reshape(-1)  # (T*K,)
    flat_w = topw.reshape(-1)
    if E_loc != cfg.num_experts:  # other experts' choices sort last, as E_loc
        flat_e = flat_e - e_lo
        flat_e = torch.where((flat_e >= 0) & (flat_e < E_loc), flat_e, E_loc)
    order = torch.argsort(flat_e, stable=True)  # group by expert
    e_sorted = flat_e[order]
    t_sorted = order // K  # flat index t*K + k -> token t
    w_sorted = flat_w[order]
    # rank within the expert's group
    starts = torch.searchsorted(e_sorted,
                                torch.arange(E_loc + 1, device=xt.device))
    rank = torch.arange(T * K, device=xt.device) - starts[e_sorted]
    # overflow and other experts' choices -> trash
    slot = torch.where((e_sorted < E_loc) & (rank < C), e_sorted * C + rank,
                       E_loc * C)

    buf = xt.new_zeros((E_loc * C + 1, d))
    xe = buf.index_copy_(0, slot, xt[t_sorted])[:-1].reshape(E_loc, C, d)

    # ---- expert compute: one batched product per weight --------------------
    if cfg.mlp_type in ("swiglu", "geglu"):
        g = torch.bmm(xe, params["w_gate"])
        gate = F.silu(g) if cfg.mlp_type == "swiglu" else F.gelu(g, approximate="tanh")
        hidden = gate * torch.bmm(xe, params["w_in"])
    else:
        hidden = F.gelu(torch.bmm(xe, params["w_in"]), approximate="tanh")
    ye = torch.bmm(hidden, params["w_out"])  # (E_loc, C, d)

    # ---- combine, in a fixed order ------------------------------------------
    # each slot's result is copied to its sorted row (a dropped row stays 0,
    # an unfilled slot goes to a trash row): the reference's gather by slot
    # has an adjoint that adds every dropped row into one trash slot, one
    # after another; this copy's adjoint is a gather
    ar = torch.arange(T * K, device=xt.device)
    row_of_slot = torch.full((E_loc * C + 1,), T * K, dtype=ar.dtype,
                             device=xt.device).scatter_(0, slot, ar)[:-1]
    y_rows = xt.new_zeros((T * K + 1, d)).index_copy_(
        0, row_of_slot, ye.reshape(E_loc * C, d))[:-1]
    y_tok = y_rows * w_sorted[:, None].to(xt.dtype)  # (T*K, d), sorted
    # each token's K rows by their place in the sorted order: a permutation
    # of the rows, gathered once and summed in order
    inv = torch.empty_like(order).scatter_(0, order, ar)
    rows = inv.reshape(T, K).sort(dim=1).values
    y_k = y_tok[rows.reshape(-1)].reshape(T, K, d).unbind(dim=1)
    out = y_k[0]
    for k in range(1, K):
        out = out + y_k[k]
    return out


def _aux(gates, topw, tope, E: int):
    """Switch-style load-balance loss over these tokens: E * sum_e (mean
    gate of e) * (routed weight on e / T)."""
    T = gates.shape[0]
    me = gates.mean(dim=0)  # (E,)
    ce = torch.zeros((T, E), dtype=torch.float32, device=gates.device).scatter_(
        1, tope, topw).sum(dim=0) / T
    return (me * ce).sum() * E


def moe_apply(params, x: torch.Tensor, cfg, mesh=None):
    """x: (B, S, d) -> (out (B, S, d), aux_loss ()) float32 aux. On a mesh
    (``x`` the rank's rows, ``params`` its slices) ``opt_moe_shard_map``
    selects ``moe_apply_shard_map``, and otherwise the global dispatch runs
    across the mesh (module docstring)."""
    check_moe(cfg, mesh)
    if mesh is not None:
        if cfg.opt_moe_shard_map and cfg.num_experts % mesh.model_size == 0:
            return moe_apply_shard_map(params, x, cfg, mesh)
        if mesh.model_size > 1 or mesh.data_size > 1:
            return _moe_apply_global(params, x, cfg, mesh)
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    gates, topw, tope = _route(xt, params["router"], cfg.moe_top_k)
    out = _dispatch(params, xt, topw, tope, cfg, moe_capacity(cfg, T))
    if cfg.num_shared_experts:
        out = out + mlp_apply(params["shared"], xt, cfg.mlp_type)
    return out.reshape(B, S, d), _aux(gates, topw, tope, cfg.num_experts)


def _moe_ranked(params, xt, cfg, mesh, C: int):
    """(out (T, d), aux) of these tokens on a rank of ``mesh``: its experts'
    slots (E/M of them where the experts are sharded) and the shared
    experts' (row-parallel where their width is), the partial parts summed
    by one ``all_reduce`` over ``model``."""
    gates, topw, tope = _route(xt, params["router"], cfg.moe_top_k)
    routed_part = model_dim(params["w_in"]) is not None
    shared_part = bool(cfg.num_shared_experts) and model_dim(
        params["shared"]["w_in"]) is not None
    # the tokens (and, for the experts, their routing weights) entering the
    # partial region; a replicated part takes them as they are
    x_r, w_r = enter(xt, topw, mesh=mesh) if routed_part else (xt, topw)
    x_s = (x_r if routed_part else enter(xt, mesh=mesh)) if shared_part \
        else xt
    routed = _dispatch(params, x_r, w_r, tope, cfg, C,
                       e_lo=mesh.model_index * params["w_in"].shape[0])
    partial, full = [], []
    (partial if routed_part else full).append(routed)
    if cfg.num_shared_experts:
        y = mlp_apply(params["shared"], x_s, cfg.mlp_type)
        (partial if shared_part else full).append(y)
    out = None
    if partial:
        out = all_reduce(functools.reduce(torch.add, partial), mesh)
    for y in full:
        out = y if out is None else out + y
    return out, _aux(gates, topw, tope, cfg.num_experts)


def _moe_apply_global(params, x, cfg, mesh):
    """The global dispatch on a mesh: every rank of a model group routes the
    tokens of all data ranks (gathered over the data axes) with the global
    capacity, computes its experts' slots, and keeps its own rows."""
    B, S, d = x.shape
    x_all = all_gather(x, mesh, dim=0, axis="data")
    T = x_all.shape[0] * S
    out, aux = _moe_ranked(params, x_all.reshape(T, d), cfg, mesh,
                           moe_capacity(cfg, T))
    i = mesh.data_index if x_all.shape[0] != B else 0
    return out.reshape(-1, S, d)[i * B:(i + 1) * B], aux


def moe_apply_shard_map(params, x: torch.Tensor, cfg, mesh):
    """The reference's expert-local dispatch (its ``moe_apply_shard_map``)
    on a rank of ``mesh``: ``x`` (B_loc, S, d) is the rank's token shard,
    ``params`` hold its E/M experts; the capacity comes from its
    T_loc = B_loc * S tokens; the experts' and the shared experts' partial
    outputs are combined by one ``all_reduce`` over ``model``; aux is the
    shard's, averaged over the data axes -> (out (B_loc, S, d), aux)."""
    if cfg.num_experts % mesh.model_size:
        raise ValueError(f"{cfg.name}: {cfg.num_experts} experts do not "
                         f"split over a model axis of {mesh.model_size}")
    B, S, d = x.shape
    T = B * S
    out, aux = _moe_ranked(params, x.reshape(T, d), cfg, mesh,
                           moe_capacity(cfg, T))
    aux = all_reduce(aux.reshape(1), mesh, axis="data")[0] / mesh.data_size
    return out.reshape(B, S, d), aux
