"""GNN layers behind the paper's layer-centric API (§6), the counterpart of
``repro/models/gnn/layers.py`` on the split and dp paths: the blocking
schedule, the overlap schedule (``_gnn_layer_overlap``) and the cached forward
(``gnn_forward_cached``), each with the replicated hot-vertex block
(``rep_block``) on the input layer; in sim form (``gnn_forward``) and in spmd
form, one split a rank over ``torch.distributed`` (``gnn_forward_spmd``).

Each layer consumes the *mixed frontier* buffer (local + received rows, built
by the shuffle) and the plan's per-edge indices, and produces the local rows of
the next depth. The JAX layer runs on one split and is vmapped over P; here
every tensor keeps its leading P axis, so the fused kernels take all splits in
one launch. A spmd rank keeps that axis with length 1: the same layers run on
its one split, and only the exchange (``core.shuffle.SpmdComm``) differs.

Supported models: GraphSAGE (mean), GAT (multi-head attention), GCN.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.shuffle import (
    SimComm,
    SpmdComm,
    chunk_slices,
    serve_features,
    shuffle,
    sim_append_replicated,
)
from repro_torch.kernels import segment_ops
from repro_torch.kernels.gather_segsum import ops as gather_ops
from repro_torch.kernels.shuffle import self_gather, send_gather

AGG_BACKENDS = ("fused", "torch")


@dataclass(frozen=True)
class GNNSpec:
    model: str = "sage"  # sage | gat | gcn
    in_dim: int = 128
    hidden_dim: int = 256  # paper default 256
    out_dim: int = 16
    num_layers: int = 3  # paper default 3
    num_heads: int = 4  # GAT only
    # Aggregation backend. "fused" (the counterpart of the JAX package's
    # "pallas") runs the CUDA gather->segment kernels over the plan's
    # dst-sorted layout — on CPU tensors, their plain versions. "torch" (the
    # counterpart of "jnp") materializes the (E, F) per-edge buffer and
    # scatter-adds it.
    agg_backend: str = "fused"
    # Overlap-aware shuffle schedule (DESIGN.md §3a). ``overlap`` switches
    # the per-layer step from blocking shuffle->aggregate to split
    # aggregation: the local-src half is aggregated from the split's own
    # rows, the remote-src half from the received rows. ``shuffle_chunks``
    # tiles that exchange along the feature axis. ``wire_dtype`` down-casts
    # only the rows on the wire (fp32 accumulation everywhere); fp32 wire is
    # bit-exact.
    overlap: bool = False
    shuffle_chunks: int = 1
    wire_dtype: str = "float32"  # float32 | bfloat16 | float16
    dtype: str = "float32"

    def layer_dims(self) -> list[tuple[int, int]]:
        dims = []
        d_in = self.in_dim
        for i in range(self.num_layers):
            d_out = self.out_dim if i == self.num_layers - 1 else self.hidden_dim
            dims.append((d_in, d_out))
            d_in = d_out
        return dims


def _param_shapes(spec: GNNSpec, d_in: int, d_out: int) -> dict:
    """Per-layer parameter names and shapes, as ``init_gnn_params`` has them."""
    if spec.model == "sage":
        return {"w_self": (d_in, d_out), "w_neigh": (d_in, d_out), "b": (d_out,)}
    if spec.model == "gcn":
        return {"w": (d_in, d_out), "b": (d_out,)}
    if spec.model == "gat":
        H = spec.num_heads
        dh = d_out // H
        if dh * H != d_out:
            raise ValueError("gat: out dim must divide num_heads")
        return {"w": (d_in, H, dh), "a_src": (H, dh), "a_dst": (H, dh),
                "b": (d_out,)}
    raise ValueError(f"unknown GNN model {spec.model!r}")


class GNN(nn.Module):
    """The model's parameters, one ``ParameterDict`` per layer with the JAX
    package's names (``layers.<i>.w_self`` ...). ``forward`` is
    ``gnn_forward``.

    Initialization draws Glorot-uniform weights (the JAX limits, with the
    glorot fan of the last two axes) from an explicit ``torch.Generator``;
    biases start at zero. It does not reproduce ``jax.random``'s bits: load
    the JAX package's parameters with ``params_from_jax`` for parity.
    """

    def __init__(self, spec: GNNSpec, generator: torch.Generator | None = None):
        super().__init__()
        if spec.agg_backend not in AGG_BACKENDS:
            raise ValueError(
                f"unknown agg_backend {spec.agg_backend!r} {AGG_BACKENDS}"
            )
        self.spec = spec
        dtype = getattr(torch, spec.dtype)
        layers = []
        for d_in, d_out in spec.layer_dims():
            params = {}
            for name, shape in _param_shapes(spec, d_in, d_out).items():
                t = torch.zeros(shape, dtype=dtype)
                if name != "b":
                    lim = float(np.sqrt(6.0 / (shape[-2] + shape[-1])))
                    t.uniform_(-lim, lim, generator=generator)
                params[name] = nn.Parameter(t)
            layers.append(nn.ParameterDict(params))
        self.layers = nn.ModuleList(layers)

    def forward(self, h_input, plan_arrays):
        return gnn_forward(self.spec, list(self.layers), h_input, plan_arrays)


def params_from_jax(np_params: list[dict], spec: GNNSpec, device) -> GNN:
    """A ``GNN`` holding the JAX package's parameters (``init_gnn_params``
    output converted to numpy arrays), so both packages compute the same
    thing from the same weights."""
    model = GNN(spec)
    with torch.no_grad():
        for layer, src in zip(model.layers, np_params):
            if set(layer.keys()) != set(src.keys()):
                raise ValueError(
                    f"parameter names {sorted(src)} != {sorted(layer.keys())}"
                )
            for name, p in layer.items():
                value = torch.as_tensor(np.array(src[name]))
                if value.shape != p.shape:
                    raise ValueError(
                        f"{name}: shape {tuple(value.shape)} != {tuple(p.shape)}"
                    )
                p.copy_(value)
    return model.to(device)


def _flat_edges(lp: dict, mem_rows: int, num_out: int):
    """Edge indices into the P-flattened row spaces (split p's rows offset by
    p*rows), so one index op serves all splits."""
    P = lp["edge_src"].shape[0]
    split = torch.arange(P, device=lp["edge_src"].device)[:, None]
    src = (lp["edge_src"].long() + split * mem_rows).reshape(-1)
    dst = (lp["edge_dst"].long() + split * num_out).reshape(-1)
    return src, dst, lp["edge_mask"].reshape(-1)


def _agg_mean(spec, mixed, lp, num_out):
    """Masked mean of ``mixed[edge_src]`` per destination, per split."""
    if spec.agg_backend == "fused":
        return gather_ops.gather_segment_mean(
            mixed, lp["edge_src"], lp["pack_perm"], lp["pack_dst"],
            lp["seg_offsets"], num_out,
        )
    P, M, Fi = mixed.shape
    src, dst, mask = _flat_edges(lp, M, num_out)
    h_src = mixed.reshape(P * M, Fi)[src]  # (P*E, F) — the buffer fused avoids
    out = segment_ops.segment_mean(h_src, dst, mask, P * num_out)
    return out.reshape(P, num_out, Fi)


def _agg_weighted_sum(spec, mixed_flat, alpha, lp, num_out):
    """GAT aggregation: sum of alpha[e, h] * mixed[src, head h's columns]."""
    if spec.agg_backend == "fused":
        return gather_ops.gather_weighted_segsum(
            mixed_flat, alpha, lp["edge_src"], lp["pack_perm"],
            lp["pack_dst"], num_out,
        )
    P, M, Fo = mixed_flat.shape
    E, H = alpha.shape[1:]
    src, dst, mask = _flat_edges(lp, M, num_out)
    msg = mixed_flat.reshape(P * M, Fo)[src].reshape(P * E, H, Fo // H)
    msg = msg * alpha.reshape(P * E, H)[:, :, None]
    out = segment_ops.segment_sum(msg.reshape(P * E, Fo), dst, mask, P * num_out)
    return out.reshape(P, num_out, Fo)


def gnn_layer_apply(spec, layer_params, mixed, lp, num_out, is_last):
    """One GNN layer on all P splits (the layer-centric 'black box').

    mixed (P, M, F_in); ``lp`` is one LayerPlan's device arrays (leading P
    axis, ``plan_io.plan_to_device``), carrying both addressings of the same
    edge set: edge order for the "torch" backend, the dst-sorted packed layout
    for "fused". Returns (P, num_out, F_out).
    """
    P = mixed.shape[0]
    split = torch.arange(P, device=mixed.device)[:, None]
    # the self rows, mixed[split, self_pos]: their adjoint reads only the
    # valid destinations (kernels/shuffle)
    self_pos, dst_count = lp["self_pos"], lp["dst_count"]
    if spec.model == "sage":
        agg = _agg_mean(spec, mixed, lp, num_out)
        h_self = self_gather(mixed, self_pos, dst_count)
        out = h_self @ layer_params["w_self"] + agg @ layer_params["w_neigh"]
        out = out + layer_params["b"]
    elif spec.model == "gcn":
        agg = _agg_mean(spec, mixed, lp, num_out)
        out = agg @ layer_params["w"] + layer_params["b"]
    elif spec.model == "gat":
        w = layer_params["w"]  # (F_in, H, dh), head-major columns
        H, dh = w.shape[1], w.shape[2]
        wh = torch.einsum("pmf,fhd->pmhd", mixed, w)  # (P, M, H, dh)
        s_src = torch.einsum("pmhd,hd->pmh", wh, layer_params["a_src"])
        # dst scores from the N_i local destination rows only (self_pos), as
        # in the reference: one (N_i, H) table and a single (E, H) gather
        wh_self = self_gather(wh.reshape(P, wh.shape[1], H * dh), self_pos,
                              dst_count).reshape(P, num_out, H, dh)
        s_dst_n = torch.einsum("pnhd,hd->pnh", wh_self, layer_params["a_dst"])
        logits = F.leaky_relu(
            s_src[split, lp["edge_src"].long()]
            + s_dst_n[split, lp["edge_dst"].long()],
            negative_slope=0.2,
        )  # (P, E, H)
        # the softmax stays on the plain path in both backends, as in the
        # reference: it is dh times smaller than the feature traffic
        E = logits.shape[1]
        flat_dst = (lp["edge_dst"].long() + split * num_out).reshape(-1)
        alpha = segment_ops.edge_softmax(
            logits.reshape(P * E, H), flat_dst, lp["edge_mask"].reshape(-1),
            P * num_out,
        ).reshape(P, E, H)
        agg = _agg_weighted_sum(
            spec, wh.reshape(P, wh.shape[1], H * dh), alpha, lp, num_out
        )
        out = agg + layer_params["b"]
    else:
        raise ValueError(spec.model)
    if not is_last:
        out = torch.relu(out)
    return out


def _half_sum(spec, rows, lp, side, num_out):
    """Per-split partial sum over one edge half (``side`` in {"l", "r"}) ->
    (P, num_out, F).

    ``rows (P, M, F)`` is the half's source space: the local row block for
    "l", the recv region (P*S rows) for "r" (half ``*edge_src`` entries index
    it directly, and the fused op takes its padding sentinel from its height).
    A zero-width half contributes exact zeros and launches nothing: an
    all-local layer and P=1 hit this path.
    """
    src = lp[f"{side}edge_src"]
    P, M, Fr = rows.shape
    if src.shape[1] == 0:
        return rows.new_zeros((P, num_out, Fr))
    if spec.agg_backend == "fused":
        return gather_ops.gather_segment_sum(
            rows, src, lp[f"{side}pack_perm"], lp[f"{side}pack_dst"], num_out
        )
    split = torch.arange(P, device=rows.device)[:, None]
    flat_src = (src.long() + split * M).reshape(-1)
    flat_dst = (lp[f"{side}edge_dst"].long() + split * num_out).reshape(-1)
    out = segment_ops.segment_sum(
        rows.reshape(P * M, Fr)[flat_src], flat_dst,
        lp[f"{side}edge_mask"].reshape(-1), P * num_out,
    )
    return out.reshape(P, num_out, Fr)


def _half_weighted(spec, rows, alpha_half, lp, side, num_out, dh):
    """Per-split weighted partial sum over one edge half (GAT) ->
    (P, num_out, Hc*dh).

    ``rows (P, M, Hc*dh)`` carries whole heads (chunk boundaries are
    dh-aligned); ``alpha_half (P, EW, Hc)`` is the half's attention weights
    sliced to the chunk's heads (a strided view: the fused op gathers it into
    the pack). Padding slots are killed by the half mask (torch) or the pack
    sentinel (fused), so stale alpha values at masked positions are never
    read. A zero-width half gives exact zeros and launches nothing.
    """
    src = lp[f"{side}edge_src"]
    P, M, Fr = rows.shape
    if src.shape[1] == 0:
        return rows.new_zeros((P, num_out, Fr))
    if spec.agg_backend == "fused":
        return gather_ops.gather_weighted_segsum(
            rows, alpha_half, src, lp[f"{side}pack_perm"],
            lp[f"{side}pack_dst"], num_out,
        )
    E, Hc = alpha_half.shape[1:]
    split = torch.arange(P, device=rows.device)[:, None]
    flat_src = (src.long() + split * M).reshape(-1)
    flat_dst = (lp[f"{side}edge_dst"].long() + split * num_out).reshape(-1)
    msg = rows.reshape(P * M, Fr)[flat_src].reshape(P * E, Hc, dh)
    msg = msg * alpha_half.reshape(P * E, Hc)[:, :, None]
    out = segment_ops.segment_sum(
        msg.reshape(P * E, Fr), flat_dst, lp[f"{side}edge_mask"].reshape(-1),
        P * num_out,
    )
    return out.reshape(P, num_out, Fr)


def _gnn_layer_overlap(spec, layer_params, h, lp, num_out, is_last, comm,
                       rep_block=None):
    """One GNN layer on all P splits under the overlap schedule (DESIGN.md
    §3a), the counterpart of the JAX ``_gnn_layer_overlap``; ``comm``
    (``SimComm`` or ``SpmdComm``) is the exchange, and on a spmd rank the
    leading axis is its one split.

    Split aggregation: the local-src half of the edge set is aggregated from
    each split's own rows ``h (P, N, F)``, the remote half from the received
    rows, and the exchange is tiled along the feature axis
    (``spec.shuffle_chunks``) so each chunk's remote partial depends only on
    its own recv block; rows travel in ``spec.wire_dtype`` (fp32
    accumulation throughout). The send buffer is gathered once
    (``send_gather``); each chunk is a slice of it, so autograd's slice
    adjoint sums the chunks' cotangents into one ``shuffle_bwd`` call.
    Equal to the blocking ``gnn_layer_apply`` within fp tolerance (the
    partial sums reassociate the edge reduction).

    GAT exchanges *transformed* rows (``wh = h @ w``, computed on the owner)
    plus an eager exchange of the (N, H) a_src scores, so attention weights
    for all edges are available before any feature chunk lands.

    ``rep_block (R, F)`` (input layer only) holds the replicated feature
    rows: the plan's local half addresses ``concat([local rows, replicated
    rows])``, so the block is appended to the local half's rows (a
    broadcast, nothing on the wire) and replicated-source edges aggregate in
    the local partial. GAT transforms and scores the block like local rows.
    """
    wire = spec.wire_dtype
    send_idx, send_count = lp["send_idx"], lp["send_count"]
    self_pos, dst_count = lp["self_pos"], lp["dst_count"]
    P, N = h.shape[:2]
    S = send_idx.shape[-1]
    split = torch.arange(P, device=h.device)[:, None]
    if spec.model in ("sage", "gcn"):
        payload = h  # rows travel as raw features, like the blocking path
        pay_rep = rep_block  # raw features for the replicated rows too
        align = 1
    elif spec.model == "gat":
        w = layer_params["w"]  # (F_in, H, dh)
        H, dh = w.shape[1], w.shape[2]
        wh = torch.einsum("pnf,fhd->pnhd", h, w)
        payload = wh.reshape(P, N, H * dh)
        if rep_block is not None:
            wh_rep = torch.einsum("rf,fhd->rhd", rep_block, w)  # (R, H, dh)
            pay_rep = wh_rep.reshape(wh_rep.shape[0], H * dh)
        else:
            pay_rep = None
        align = dh
    else:
        raise ValueError(spec.model)
    F_out = payload.shape[-1]
    slices = chunk_slices(F_out, spec.shuffle_chunks, align)
    has_remote = S > 0 and lp["redge_src"].shape[-1] > 0
    send = send_gather(payload, send_idx, send_count) if has_remote else None
    # the local half's source space: [local rows][replicated rows]
    loc_rows = (payload if pay_rep is None
                else sim_append_replicated(payload, pay_rep))

    def recv_chunk(sl):
        return comm.exchange(send[..., sl], wire)  # (P, P*S, Fc)

    if spec.model in ("sage", "gcn"):
        loc = _half_sum(spec, loc_rows, lp, "l", num_out)
        if has_remote:
            rem = torch.cat([_half_sum(spec, recv_chunk(sl), lp, "r", num_out)
                             for sl in slices], dim=-1)
        else:
            rem = torch.zeros_like(loc)
        seg = lp["seg_offsets"]
        count = (seg[:, 1:] - seg[:, :-1]).to(loc.dtype)
        agg = (loc + rem) / count.clamp(min=1.0)[:, :, None]
        if spec.model == "sage":
            h_self = self_gather(h, self_pos, dst_count)
            out = h_self @ layer_params["w_self"] + agg @ layer_params["w_neigh"]
            out = out + layer_params["b"]
        else:
            out = agg @ layer_params["w"] + layer_params["b"]
    else:  # gat
        s_src_loc = torch.einsum("pnhd,hd->pnh", wh, layer_params["a_src"])
        if S > 0:
            # eager score exchange: H columns per row against H*dh for the
            # features — the small price that lets every feature chunk
            # aggregate independently (alpha is feature-independent)
            s_recv = comm.exchange(
                send_gather(s_src_loc, send_idx, send_count), wire)
            s_src_mix = torch.cat([s_src_loc, s_recv], dim=1)
        else:
            s_src_mix = s_src_loc
        if pay_rep is not None:
            # replicated rows sit past the recv region in the mixed source
            # space; their a_src scores are computed here like local rows'
            s_rep = torch.einsum("rhd,hd->rh", wh_rep, layer_params["a_src"])
            s_src_mix = sim_append_replicated(s_src_mix, s_rep)
        wh_self = self_gather(payload, self_pos, dst_count).reshape(
            P, num_out, H, dh)
        s_dst_n = torch.einsum("pnhd,hd->pnh", wh_self, layer_params["a_dst"])
        logits = F.leaky_relu(
            s_src_mix[split, lp["edge_src"].long()]
            + s_dst_n[split, lp["edge_dst"].long()],
            negative_slope=0.2,
        )  # (P, E, H)
        E = logits.shape[1]
        flat_dst = (lp["edge_dst"].long() + split * num_out).reshape(-1)
        alpha = segment_ops.edge_softmax(
            logits.reshape(P * E, H), flat_dst, lp["edge_mask"].reshape(-1),
            P * num_out,
        ).reshape(P, E, H)
        loc = _half_weighted(spec, loc_rows, alpha[split, lp["ledge_ids"].long()],
                             lp, "l", num_out, dh)
        if has_remote:
            a_rem = alpha[split, lp["redge_ids"].long()]  # (P, ER, H)
            rem = torch.cat([
                _half_weighted(
                    spec, recv_chunk(sl),
                    a_rem[:, :, sl.start // dh:sl.stop // dh], lp, "r",
                    num_out, dh,
                )
                for sl in slices
            ], dim=-1)
        else:
            rem = torch.zeros_like(loc)
        out = loc + rem + layer_params["b"]
    if not is_last:
        out = torch.relu(out)
    return out


def gnn_forward(spec, params, h_input, plan_arrays, comm=None,
                rep_block=None):
    """Split-parallel forward pass (Algorithm 2): shuffle -> gnn layer, per
    depth, or with ``spec.overlap`` the split local/remote schedule
    (``_gnn_layer_overlap``) on plans staged with their edge halves.

    ``params`` is a list of per-layer dicts (``params[0]`` consumes the input
    features); ``h_input`` is (P, N_L, F_in). Runs depths L-1 .. 0 and returns
    (P, N_0, out_dim) target logits. ``plan_arrays['layers']`` is ordered by
    dst depth (0 = targets), so it is iterated reversed. ``comm`` is the
    exchange of both schedules: ``SimComm()`` (the default) for all P splits
    on one device, ``SpmdComm`` on one rank (``gnn_forward_spmd``).

    ``rep_block (R, F_in)`` holds the replicated hot-vertex feature rows. It
    applies to the input layer only (li == L-1): plans built with a
    replication set address those sources past the recv region, so the
    block is appended to the mixed buffer after the (smaller) shuffle.
    """
    comm = SimComm() if comm is None else comm
    L = spec.num_layers
    h = h_input
    for li in range(L - 1, -1, -1):
        lp = plan_arrays["layers"][li]
        num_out = lp["self_pos"].shape[-1]  # N_i
        rep = rep_block if li == L - 1 else None
        if spec.overlap:
            h = _gnn_layer_overlap(spec, params[L - 1 - li], h, lp, num_out,
                                   is_last=(li == 0), comm=comm, rep_block=rep)
            continue
        mixed = shuffle(h, lp["send_idx"], comm, spec.wire_dtype,
                        send_count=lp["send_count"])  # (P, M, F)
        if rep is not None:
            mixed = sim_append_replicated(mixed, rep)
        h = gnn_layer_apply(
            spec, params[L - 1 - li], mixed, lp, num_out, is_last=(li == 0)
        )
    return h


def gnn_forward_cached(spec, params, cache_block, miss_feats, plan_arrays,
                       comm=None, rep_block=None):
    """Split-parallel forward with the loading stage folded into the step.

    Instead of a pre-gathered (P, N_L, F) block, the input features are
    assembled on the device from the resident cache block ``(P, C, F)`` and
    the compacted miss rows ``(P, M, F)`` (``core.shuffle.serve_features``
    over ``plan_arrays["cache"]``): the same numbers as
    ``gnn_forward(load_features(...))``, while the host link carried only
    the misses.
    """
    comm = SimComm() if comm is None else comm
    h_input = serve_features(cache_block, plan_arrays["cache"], miss_feats,
                             comm, spec.wire_dtype)
    return gnn_forward(spec, params, h_input, plan_arrays, comm,
                       rep_block=rep_block)


def gnn_forward_spmd(spec, params, h_input, plan_arrays, group,
                     cache_local=None, rep_block=None):
    """The forward on one rank of ``group`` (its split group), the
    counterpart of the JAX ``gnn_forward_spmd``: ``gnn_forward`` (or, with
    ``cache_local``, ``gnn_forward_cached``) over ``SpmdComm(group)``, the
    same math on the rank's split.

    ``h_input`` is the rank's (1, N_L, F_in) input rows, or with
    ``cache_local`` (its (1, C, F) resident block) its (1, M, F) miss rows;
    ``plan_arrays`` holds the rank's slice of every plan array
    (``launch.sharding.plan_slice``). ``rep_block`` is the whole replicated
    block, the same on every rank. Returns the rank's (1, N_0, out_dim)
    target logits. Every rank of the group must call it with plans of one
    shape: each layer's exchange is a collective.
    """
    comm = SpmdComm(group)
    if cache_local is not None:
        return gnn_forward_cached(spec, params, cache_local, h_input,
                                  plan_arrays, comm, rep_block=rep_block)
    return gnn_forward(spec, params, h_input, plan_arrays, comm,
                       rep_block=rep_block)
