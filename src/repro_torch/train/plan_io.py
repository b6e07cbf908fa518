"""Host plan -> device tensors, and the feature/label loading stage (the
counterpart of ``repro/train/plan_io.py`` without cache serving).

``stage_batch`` moves one delivered batch to the device. On a CUDA device it
packs every int32 and bool array of the repadded plan, and the labels, into
one pinned host buffer, issues one ``non_blocking`` copy of it, and hands out
device views with ``plan_to_device``'s keys; the feature block, gathered by
the producer straight into pinned memory at its unpadded height
(``gather_features``), follows in a second ``non_blocking`` copy and is
padded on the device. Pinned blocks come from torch's caching host
allocator, which does not reuse a block until the copies from it have ended.
Every staged tensor is byte-equal to the pageable per-array staging of
``plan_to_device``. On any other device (the tests' ``device="cpu"``)
staging is the plain ``torch.as_tensor`` of each array.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.splitting import SplitPlan

#: byte alignment of each array in the packed staging buffer: the alignment
#: a fresh device allocation has, so every view is as aligned as a tensor of
#: its own would be
ALIGN = 256
_TORCH_DTYPE = {np.dtype(np.int32): torch.int32, np.dtype(bool): torch.bool}


def _plan_fields(plan: SplitPlan):
    """``(layer or None, key, array)`` for every array the step reads, as
    contiguous int32 or bool numpy arrays, in one fixed order."""
    for i, lp in enumerate(plan.layers):
        for key, a in (
            ("edge_src", lp.edge_src),
            ("edge_dst", lp.edge_dst),
            ("edge_mask", lp.edge_mask),
            ("send_idx", lp.send_idx),
            ("send_count", lp.send_count),
            ("self_pos", lp.self_pos),
            # valid destination rows per split (depth i): the self rows
            ("dst_count", plan.node_count[i]),
            # dst-sorted layout for the fused aggregation kernels
            ("pack_perm", lp.pack_perm),
            ("pack_dst", lp.pack_dst),
            ("seg_offsets", lp.seg_offsets),
        ):
            yield i, key, _host(a, bool if key == "edge_mask" else np.int32)
    yield None, "target_mask", _host(plan.node_mask[0], bool)
    yield None, "input_mask", _host(plan.node_mask[-1], bool)


def _host(a: np.ndarray, dtype) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=dtype)


def _assemble(num_layers: int, items) -> dict:
    """The plan dict from ``(layer or None, key, tensor)`` items."""
    out: dict = {"layers": [{} for _ in range(num_layers)]}
    for layer, key, t in items:
        (out if layer is None else out["layers"][layer])[key] = t
    return out


def plan_to_device(plan: SplitPlan, device) -> dict:
    """A SplitPlan as a dict of device tensors (indices int32), with the JAX
    package's keys: ``layers`` (one dict per layer, by dst depth),
    ``target_mask`` and ``input_mask``. Each layer also carries the true
    sizes its gathers' adjoints read: ``send_count`` (P, P) and
    ``dst_count`` (P,). One pageable ``torch.as_tensor`` copy per array."""
    return _assemble(plan.num_layers, (
        (layer, key, torch.as_tensor(a, device=device))
        for layer, key, a in _plan_fields(plan)
    ))


def pack_host(plan: SplitPlan, labels: np.ndarray, pin: bool):
    """Every plan array and the labels in one host byte buffer (pinned when
    ``pin``): ``(buffer, spans)``, where each span ``(layer or None, key,
    offset, dtype, shape)`` places one array at an ``ALIGN``-byte offset.
    The labels' span comes last, under the key ``"labels"``."""
    fields = list(_plan_fields(plan))
    fields.append((None, "labels", _host(labels, np.int32)))
    spans, at = [], 0
    for layer, key, a in fields:
        spans.append((layer, key, at, a.dtype, a.shape))
        at += -(-a.nbytes // ALIGN) * ALIGN
    buf = torch.empty(at, dtype=torch.uint8, pin_memory=pin)
    view = buf.numpy()
    for (_, _, off, _, _), (_, _, a) in zip(spans, fields):
        view[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    return buf, spans


def unpack(buf: torch.Tensor, spans, num_layers: int):
    """``(plan dict, labels)`` as views of a packed buffer (on any device)."""
    items = []
    for layer, key, off, dtype, shape in spans:
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        t = buf[off:off + nbytes].view(_TORCH_DTYPE[dtype])
        items.append((layer, key, t.view(shape)))
    labels = items.pop()[2]
    return _assemble(num_layers, items), labels


def pad_rows(feats: torch.Tensor, rows: int) -> torch.Tensor:
    """Grow axis 1 of a (P, n, F) block to ``rows`` with trailing zeros, on
    the block's device: byte-equal to ``core.splitting.pad_axis``."""
    if feats.shape[1] >= rows:
        return feats
    return F.pad(feats, (0, 0, 0, rows - feats.shape[1]))


def stage_batch(plan: SplitPlan, feats: torch.Tensor, labels: np.ndarray,
                device) -> tuple:
    """One delivered batch on ``device``: ``(feats (P, N_L, F), plan dict,
    labels (P, N_0))``, with ``feats`` padded to the plan's input height.

    On a CUDA device: two ``non_blocking`` copies from pinned memory, one of
    the packed plan and labels (``pack_host``) and one of the feature block,
    which must be pinned (``gather_features(pin=True)``); a pageable block
    raises. Elsewhere, the plain per-array copies.
    """
    device = torch.device(device)
    rows = plan.front_ids[-1].shape[1]
    if device.type != "cuda":
        return (
            pad_rows(feats.to(device), rows),
            plan_to_device(plan, device),
            torch.as_tensor(labels, device=device),
        )
    if not feats.is_pinned():
        raise RuntimeError(
            "stage_batch: the feature block is not in pinned memory "
            "(gather it with gather_features(pin=True))"
        )
    buf, spans = pack_host(plan, labels, pin=True)
    plan_arrays, labels_d = unpack(
        buf.to(device, non_blocking=True), spans, plan.num_layers
    )
    return (
        pad_rows(feats.to(device, non_blocking=True), rows),
        plan_arrays,
        labels_d,
    )


def host_tensor(a: np.ndarray, pin: bool) -> torch.Tensor:
    """``a`` as a host tensor: a pinned copy when ``pin``."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if pin else t


def gather_features(plan: SplitPlan, features: np.ndarray,
                    pin: bool = False) -> torch.Tensor:
    """The *loading* phase: gather input rows per device (dedup'd under
    split) into a (P, N_L, F) float32 host tensor, pinned when ``pin``;
    padding rows zeroed."""
    ids = plan.front_ids[-1]
    out = torch.empty((*ids.shape, features.shape[1]), dtype=torch.float32,
                      pin_memory=pin)
    rows = out.numpy()
    # mode="clip" gathers without numpy's bounds-checking buffer (the ids
    # are in range): the same values as features[ids], written in place
    np.take(features, ids, axis=0, out=rows, mode="clip")
    rows[~plan.node_mask[-1]] = 0.0
    return out


def load_features(plan: SplitPlan, features: np.ndarray) -> np.ndarray:
    """``gather_features`` as a numpy array (the JAX package's
    ``load_features``): (P, N_L, F) float32, padding rows zeroed."""
    return gather_features(plan, features).numpy()


def load_labels(plan: SplitPlan, labels: np.ndarray) -> np.ndarray:
    """Labels of the (local) target rows per device, padding = 0."""
    lab = labels[plan.front_ids[0]]
    return (lab * plan.node_mask[0]).astype(np.int32)
