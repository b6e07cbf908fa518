"""Host plan -> device tensors, and the feature/label loading stage (the
counterpart of ``repro/train/plan_io.py``).

Two loading paths feed the step:

  * full host gather (``gather_features``) — every input row crosses the
    host link; the only option without a cache.
  * cache serving — only the *miss* rows are host-gathered
    (``gather_miss_features``); local/remote hits are assembled on the
    device from the resident cache block
    (``core.shuffle.sim_serve_features``). The ``CachePlan`` arrays ride
    along in the plan dict under ``"cache"``.

``stage_batch`` moves one delivered batch to the device. On a CUDA device it
packs every int32 and bool array of the repadded plan (the overlap
schedule's edge halves and the cache plan included, when the step reads
them), and the labels, into one pinned host buffer, issues one
``non_blocking`` copy of it, and hands out device views with
``plan_to_device``'s keys; the feature block (or the miss block), gathered
by the producer straight into pinned memory at its unpadded height, follows
in a second ``non_blocking`` copy and is padded on the device. Pinned blocks
come from torch's caching host allocator, which does not reuse a block until
the copies from it have ended. Every staged tensor is byte-equal to the
pageable per-array staging of ``plan_to_device``. On any other device (the
tests' ``device="cpu"``) staging is the plain ``torch.as_tensor`` of each
array.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.splitting import SplitPlan
from repro_torch.graph.cache import CachePlan

#: byte alignment of each array in the packed staging buffer: the alignment
#: a fresh device allocation has, so every view is as aligned as a tensor of
#: its own would be
ALIGN = 256
_TORCH_DTYPE = {np.dtype(np.int32): torch.int32, np.dtype(bool): torch.bool}


#: the local/remote edge halves the overlap schedule reads, per layer
HALF_KEYS = (
    "ledge_src", "ledge_dst", "ledge_mask", "ledge_ids", "lpack_perm",
    "lpack_dst", "redge_src", "redge_dst", "redge_mask", "redge_ids",
    "rpack_perm", "rpack_dst",
)
#: the cache plan's arrays the step reads (``miss_ids`` stays on the host)
CACHE_KEYS = ("local_slot", "local_mask", "send_slot", "recv_pos",
              "recv_mask", "miss_pos", "miss_mask")


def check_replicated(plan: SplitPlan, num_replicated: int) -> None:
    """Raise unless the plan's replicated region is ``num_replicated`` rows.

    A plan built with a replication set addresses sources past the recv
    region on the assumption that exactly R replicated rows are appended to
    the mixed buffer; a block of another height is a silent wrong gather,
    so staging rejects the mismatch.
    """
    rep = plan.layers[-1].num_replicated if plan.layers else 0
    if rep != num_replicated:
        raise ValueError(
            f"plan carries {rep} replicated source rows but the trainer "
            f"serves a block of {num_replicated} — the plan builder and the "
            "resident replication block must come from the same "
            "ReplicationSet"
        )


def _plan_fields(plan: SplitPlan, cache_plan: CachePlan | None = None,
                 with_halves: bool = False, num_replicated: int = 0):
    """``(place, key, array)`` for every array the step reads, as contiguous
    int32 or bool numpy arrays, in one fixed order. ``place`` is a layer's
    index, None for the plan's top level, or ``"cache"``. Raises unless the
    plan's replicated region is ``num_replicated`` rows high."""
    check_replicated(plan, num_replicated)
    for i, lp in enumerate(plan.layers):
        if with_halves and not lp.has_halves:
            raise ValueError(
                "plan was built without edge halves "
                "(build_split_plan(with_halves=False)) but the overlap "
                "schedule needs them — builder and trainer must agree on the "
                "shuffle_overlap knob"
            )
        halves = [(k, getattr(lp, k)) for k in HALF_KEYS] if with_halves else []
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
            *halves,
        ):
            yield i, key, _host(a, bool if a.dtype == bool else np.int32)
    yield None, "target_mask", _host(plan.node_mask[0], bool)
    yield None, "input_mask", _host(plan.node_mask[-1], bool)
    if cache_plan is not None:
        yield from _cache_fields(cache_plan)


def _cache_fields(cp: CachePlan):
    for key in CACHE_KEYS:
        a = getattr(cp, key)
        yield "cache", key, _host(a, bool if a.dtype == bool else np.int32)


def _host(a: np.ndarray, dtype) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=dtype)


def _assemble(num_layers: int, items) -> dict:
    """The plan dict from ``(layer or None, key, tensor)`` items."""
    out: dict = {"layers": [{} for _ in range(num_layers)]}
    for place, key, t in items:
        if place is None:
            out[key] = t
        elif place == "cache":
            out.setdefault("cache", {})[key] = t
        else:
            out["layers"][place][key] = t
    return out


def cache_plan_to_device(cp: CachePlan, device) -> dict:
    """A CachePlan as a dict of device tensors (``miss_ids`` stays on the
    host: the producer gathered its rows)."""
    return {key: torch.as_tensor(a, device=device)
            for _, key, a in _cache_fields(cp)}


def plan_to_device(plan: SplitPlan, device, cache_plan: CachePlan | None = None,
                   with_halves: bool = False, num_replicated: int = 0) -> dict:
    """A SplitPlan as a dict of device tensors (indices int32), with the JAX
    package's keys: ``layers`` (one dict per layer, by dst depth),
    ``target_mask`` and ``input_mask``, and ``cache`` with a cache plan.
    Each layer also carries the true sizes its gathers' adjoints read:
    ``send_count`` (P, P) and ``dst_count`` (P,); ``with_halves`` ships the
    local/remote edge halves the overlap schedule reads (the blocking path
    neither builds nor stages them). ``num_replicated`` is the height of the
    replicated block the step appends (0 without replication); a plan built
    for another height raises. One pageable ``torch.as_tensor`` copy per
    array."""
    return _assemble(plan.num_layers, (
        (place, key, torch.as_tensor(a, device=device))
        for place, key, a in _plan_fields(plan, cache_plan, with_halves,
                                          num_replicated)
    ))


def batch_fields(plan: SplitPlan, labels: np.ndarray,
                 cache_plan: CachePlan | None = None, with_halves: bool = False,
                 num_replicated: int = 0) -> list:
    """``(place, key, array)`` for every array ``stage_batch`` stages: the
    plan's (``plan_to_device``'s), then the labels under ``"labels"``."""
    fields = list(_plan_fields(plan, cache_plan, with_halves, num_replicated))
    fields.append((None, "labels", _host(labels, np.int32)))
    return fields


def pack_host(plan: SplitPlan, labels: np.ndarray, pin: bool,
              cache_plan: CachePlan | None = None, with_halves: bool = False,
              num_replicated: int = 0):
    """Every plan array (``plan_to_device``'s) and the labels in one host
    byte buffer (pinned when ``pin``): ``(buffer, spans)``, where each span
    ``(place, key, offset, dtype, shape)`` places one array at an
    ``ALIGN``-byte offset. The labels' span comes last, under the key
    ``"labels"``. A zero-size array (a dp plan's ``send_idx``) takes no
    bytes: its span starts where the next array's does."""
    return _pack(batch_fields(plan, labels, cache_plan, with_halves,
                              num_replicated), pin)


def _layout(fields: list) -> tuple:
    """``(spans, bytes)`` of the packed buffer of ``fields``."""
    spans, at = [], 0
    for layer, key, a in fields:
        spans.append((layer, key, at, a.dtype, a.shape))
        at += -(-a.nbytes // ALIGN) * ALIGN
    return spans, at


def _pack(fields: list, pin: bool):
    spans, nbytes = _layout(fields)
    buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
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
                device, cache_plan: CachePlan | None = None,
                with_halves: bool = False, num_replicated: int = 0,
                counts: dict | None = None) -> tuple:
    """One delivered batch on ``device``: ``(feats, plan dict, labels
    (P, N_0))``. ``feats`` is padded on the device to the plan's input
    height, or with a cache plan to its miss width (the (P, M, F) miss block
    the cached step reads beside the resident block).

    On a CUDA device: two ``non_blocking`` copies from pinned memory, one of
    the packed plan, halves, cache plan and labels (``pack_host``) and one of
    the feature block, which must be pinned
    (``gather_features``/``gather_miss_features`` with ``pin=True``); a
    pageable block raises. Elsewhere, the plain per-array copies. A plan
    whose replicated region is not ``num_replicated`` rows high raises on
    either path. ``counts`` is ``stage_fields``'.
    """
    return stage_fields(
        batch_fields(plan, labels, cache_plan, with_halves, num_replicated),
        feats, staged_rows(plan, cache_plan), device, plan.num_layers, counts,
    )


def staged_rows(plan: SplitPlan, cache_plan: CachePlan | None = None) -> int:
    """The height ``stage_batch`` pads the feature block to: the plan's
    input height, or with a cache plan its miss width."""
    if cache_plan is not None:
        return cache_plan.max_miss
    return plan.front_ids[-1].shape[1]


def stage_fields(fields: list, feats: torch.Tensor, rows: int, device,
                 num_layers: int, counts: dict | None = None) -> tuple:
    """``stage_batch`` on its ``batch_fields`` (or any slice of each, as a
    spmd rank stages its split): ``(feats padded to rows, plan dict,
    labels)`` on ``device``, by the two pinned copies on a card and the
    plain per-array copies elsewhere. With ``counts``, the bytes the two
    copies carry (the packed buffer's and the feature block's; the same
    count off the card) are added to ``counts["h2d_bytes"]``."""
    device = torch.device(device)
    if device.type != "cuda":
        if counts is not None:
            counts["h2d_bytes"] += _layout(fields)[1] + feats.nbytes
        items = [(place, key, torch.as_tensor(a, device=device))
                 for place, key, a in fields]
        labels_d = items.pop()[2]
        return (pad_rows(feats.to(device), rows),
                _assemble(num_layers, items), labels_d)
    # a batch whose every input row is a cache hit has an empty miss block
    if feats.numel() and not feats.is_pinned():
        raise RuntimeError(
            "stage_batch: the feature block is not in pinned memory "
            "(gather it with gather_features(pin=True))"
        )
    buf, spans = _pack(fields, pin=True)
    if counts is not None:
        counts["h2d_bytes"] += buf.nbytes + feats.nbytes
    plan_arrays, labels_d = unpack(
        buf.to(device, non_blocking=True), spans, num_layers
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


def _gather_rows(ids: np.ndarray, mask: np.ndarray, features: np.ndarray,
                 pin: bool) -> torch.Tensor:
    """``features[ids]`` as a float32 host tensor (pinned when ``pin``),
    rows where ``mask`` is False zeroed."""
    out = torch.empty((*ids.shape, features.shape[1]), dtype=torch.float32,
                      pin_memory=pin)
    rows = out.numpy()
    # mode="clip" gathers without numpy's bounds-checking buffer (the ids
    # are in range): the same values as features[ids], written in place
    np.take(features, ids, axis=0, out=rows, mode="clip")
    rows[~mask] = 0.0
    return out


def gather_features(plan: SplitPlan, features: np.ndarray,
                    pin: bool = False) -> torch.Tensor:
    """The *loading* phase: gather input rows per device (dedup'd under
    split) into a (P, N_L, F) float32 host tensor, pinned when ``pin``;
    padding rows zeroed."""
    return _gather_rows(plan.front_ids[-1], plan.node_mask[-1], features, pin)


def gather_miss_features(cp: CachePlan, features: np.ndarray,
                         pin: bool = False) -> torch.Tensor:
    """Host gather of only the cache-miss rows: a (P, M, F) float32 host
    tensor, pinned when ``pin``, padding rows zeroed. The host link carries
    ``M`` rows per device instead of ``N_L``."""
    return _gather_rows(cp.miss_ids, cp.miss_mask, features, pin)


def load_miss_features(cp: CachePlan, features: np.ndarray) -> np.ndarray:
    """``gather_miss_features`` as a numpy array (the JAX package's
    ``load_miss_features``)."""
    return gather_miss_features(cp, features).numpy()


def stage_host_features(plan: SplitPlan, features: np.ndarray, cache=None,
                        serve_cache: bool = False, pad_multiple: int = 8,
                        pin: bool = False) -> tuple:
    """The load stage for one plan: ``(cache_plan, feats, breakdown)``, with
    ``feats`` a host tensor (pinned when ``pin``).

    Chooses the serving path (compacted miss gather + CachePlan) or the full
    host gather. The single definition shared by ``PlanProducer.build``
    (producer threads) and ``Trainer.train_iter`` (inline path), so the two
    stay bit-identical.
    """
    if cache is not None and serve_cache and cache.serves:
        cp = cache.build_plan(plan, pad_multiple=pad_multiple)
        return cp, gather_miss_features(cp, features, pin), cp.breakdown()
    feats = gather_features(plan, features, pin)
    return None, feats, (cache.classify_plan(plan) if cache else None)


def load_features(plan: SplitPlan, features: np.ndarray) -> np.ndarray:
    """``gather_features`` as a numpy array (the JAX package's
    ``load_features``): (P, N_L, F) float32, padding rows zeroed."""
    return gather_features(plan, features).numpy()


def load_labels(plan: SplitPlan, labels: np.ndarray) -> np.ndarray:
    """Labels of the (local) target rows per device, padding = 0."""
    lab = labels[plan.front_ids[0]]
    return (lab * plan.node_mask[0]).astype(np.int32)
