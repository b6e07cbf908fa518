"""Host plan -> device tensors, and the feature/label loading stage (the
counterpart of ``repro/train/plan_io.py`` without cache serving)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.splitting import SplitPlan


def _idx(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)


def _mask(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=bool), device=device)


def plan_to_device(plan: SplitPlan, device) -> dict:
    """A SplitPlan as a dict of device tensors (indices int32), with the JAX
    package's keys: ``layers`` (one dict per layer, by dst depth),
    ``target_mask`` and ``input_mask``. Each layer also carries the true
    sizes its gathers' adjoints read: ``send_count`` (P, P) and
    ``dst_count`` (P,)."""
    layers = []
    for i, lp in enumerate(plan.layers):
        layers.append({
            "edge_src": _idx(lp.edge_src, device),
            "edge_dst": _idx(lp.edge_dst, device),
            "edge_mask": _mask(lp.edge_mask, device),
            "send_idx": _idx(lp.send_idx, device),
            "send_count": _idx(lp.send_count, device),
            "self_pos": _idx(lp.self_pos, device),
            # valid destination rows per split (depth i): the self rows
            "dst_count": _idx(plan.node_count[i], device),
            # dst-sorted layout for the fused aggregation kernels
            "pack_perm": _idx(lp.pack_perm, device),
            "pack_dst": _idx(lp.pack_dst, device),
            "seg_offsets": _idx(lp.seg_offsets, device),
        })
    return {
        "layers": layers,
        "target_mask": _mask(plan.node_mask[0], device),
        "input_mask": _mask(plan.node_mask[-1], device),
    }


def load_features(plan: SplitPlan, features: np.ndarray) -> np.ndarray:
    """The *loading* phase: gather input rows per device (dedup'd under
    split). Returns (P, N_L, F) float32; padding rows zeroed."""
    rows = features[plan.front_ids[-1]].astype(np.float32, copy=False)
    rows[~plan.node_mask[-1]] = 0.0
    return rows


def load_labels(plan: SplitPlan, labels: np.ndarray) -> np.ndarray:
    """Labels of the (local) target rows per device, padding = 0."""
    lab = labels[plan.front_ids[0]]
    return (lab * plan.node_mask[0]).astype(np.int32)
