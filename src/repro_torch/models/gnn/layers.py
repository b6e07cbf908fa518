"""GNN layers behind the paper's layer-centric API (§6), the counterpart of
``repro/models/gnn/layers.py`` on the blocking split path.

Each layer consumes the *mixed frontier* buffer (local + received rows, built
by the shuffle) and the plan's per-edge indices, and produces the local rows of
the next depth. The JAX layer runs on one split and is vmapped over P; here
every tensor keeps its leading P axis, so the fused kernels take all splits in
one launch.

Supported models: GraphSAGE (mean), GAT (multi-head attention), GCN.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.shuffle import sim_shuffle
from repro_torch.kernels import segment_ops
from repro_torch.kernels.gather_segsum import ops as gather_ops
from repro_torch.kernels.shuffle import self_gather

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


def gnn_forward(spec, params, h_input, plan_arrays, shuffle_fn=sim_shuffle):
    """Split-parallel forward pass (Algorithm 2), blocking schedule:
    shuffle -> gnn layer, per depth.

    ``params`` is a list of per-layer dicts (``params[0]`` consumes the input
    features); ``h_input`` is (P, N_L, F_in). Runs depths L-1 .. 0 and returns
    (P, N_0, out_dim) target logits. ``plan_arrays['layers']`` is ordered by
    dst depth (0 = targets), so it is iterated reversed.
    """
    h = h_input
    L = spec.num_layers
    for li in range(L - 1, -1, -1):
        lp = plan_arrays["layers"][li]
        num_out = lp["self_pos"].shape[-1]  # N_i
        mixed = shuffle_fn(h, lp["send_idx"], spec.wire_dtype,
                           send_count=lp["send_count"])  # (P, M, F)
        h = gnn_layer_apply(
            spec, params[L - 1 - li], mixed, lp, num_out, is_last=(li == 0)
        )
    return h
