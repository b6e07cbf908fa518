"""What one training step launches and computes, from a plan's true sizes.

``summarize`` reads a split or dp plan (the program's ``SplitPlan``: host
numpy arrays with a leading split axis) into plain counts per layer
transition; ``launches`` lists each custom kernel's launches in one step of
the blocking schedule, with the sizes its count needs; ``model_flops`` counts
a step's model operations. Counts are summed over the splits, since every
kernel takes all splits in one launch.
"""
from __future__ import annotations

import numpy as np

from gsbench.data.weights import layer_dims


def summarize(plan) -> list:
    """Per layer transition, from the input layer up: true edges, distinct
    true source rows, true destination rows, true rows at the source depth,
    the shuffle's valid send slots and the distinct rows they name, and
    whether the layer has a shuffle at all."""
    out = []
    L = plan.num_layers
    for k in range(L):
        li = L - 1 - k  # depth of the destinations
        lp = plan.layers[li]
        P = lp.edge_src.shape[0]
        mask = lp.edge_mask
        sources = sum(np.unique(lp.edge_src[p][mask[p]]).size for p in range(P))
        sent = distinct = 0
        for q in range(P):
            rows = [lp.send_idx[q, p, :lp.send_count[q, p]] for p in range(P)]
            sent += sum(r.size for r in rows)
            distinct += np.unique(np.concatenate(rows)).size if rows else 0
        out.append({
            "edges": int(mask.sum()),
            "src_rows": int(sources),
            "dst_rows": int(plan.node_count[li].sum()),
            "depth_rows": int(plan.node_count[li + 1].sum()),
            "send_slots": int(sent),
            "send_rows": int(distinct),
            "shuffles": lp.send_idx.shape[-1] > 0,
        })
    return out


def launches(summary: list, model: dict) -> dict:
    """``{kernel: [launch, ...]}`` for one step. The forward aggregates every
    layer; the adjoints run only where their input needs a gradient: never
    for the input layer's feature rows, always for GAT's transformed rows
    and attention weights."""
    gat = model["kind"] == "gat"
    heads = model.get("num_heads", 0) if gat else 0
    out = {"gss_fwd": [], "gss_bwd_mixed": [], "gss_bwd_w": [], "shuffle_bwd": []}
    for k, (layer, (d_in, d_out)) in enumerate(zip(summary, layer_dims(model))):
        width = d_out if gat else d_in
        agg = {"width": width, "heads": heads, "edges": layer["edges"],
               "src_rows": layer["src_rows"], "dst_rows": layer["dst_rows"]}
        out["gss_fwd"].append(agg)
        rows_need_grad = gat or k > 0
        if rows_need_grad:
            out["gss_bwd_mixed"].append(agg)
            # the self rows' gather: of the transformed rows for GAT, of the
            # mixed input rows for SAGE
            out["shuffle_bwd"].append({"width": width, "slots": layer["dst_rows"],
                                       "rows": layer["dst_rows"]})
        if gat:
            out["gss_bwd_w"].append(agg)
        if k > 0 and layer["shuffles"]:
            out["shuffle_bwd"].append({"width": d_in, "slots": layer["send_slots"],
                                       "rows": layer["send_rows"]})
    return out


def model_flops(summary: list, model: dict) -> float:
    """A step's model operations: the dense products on the true rows, one
    add per edge and feature of aggregation, GAT's scores and per-edge
    attention; the backward twice the forward. Rows a split transforms again
    after receiving them are recomputation and not counted."""
    fwd = 0.0
    heads = model.get("num_heads", 1)
    for layer, (d_in, d_out) in zip(summary, layer_dims(model)):
        e, d, n = layer["edges"], layer["dst_rows"], layer["depth_rows"]
        if model["kind"] == "sage":
            fwd += 2 * 2 * d * d_in * d_out + e * d_in
        else:
            fwd += (2 * n * d_in * d_out + 2 * n * d_out + 2 * d * d_out
                    + 5 * e * heads + 2 * e * d_out)
    return 3 * fwd
