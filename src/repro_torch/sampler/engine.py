"""The cooperative sampling loop and its producer-facing facade — the
counterpart of ``repro/sampler/engine.py``.

``_sample_device`` is the steady-state path, a plain function on tensors
with the P splits as the leading axis. Per GNN layer it

  1. expands each split's locally owned frontier block with the wavefront
     kernel (``kernel.wavefront_expand``: one launch over all P * N rows;
     on the CPU its plain version),
  2. gathers the drawn edges from the device CSR shard (``shard.py``),
  3. de-duplicates the candidate next frontier per split
     (``frontier.sorted_unique_capped``),
  4. routes newly discovered remote vertices to their owning split through
     the fixed-size all-to-all (``frontier.bucket_by_owner`` builds the
     (P, P, X) send buffer; ``core.shuffle.SimComm`` exchanges it), and
  5. merges received and locally owned candidates into the next frontier.

``sample_minibatch_spmd`` is the same loop on one rank's CSR shard, over
``torch.distributed``: the rank keeps a leading split axis of length 1, its
targets are the sorted unique ones it owns, and the exchange is
``core.shuffle.SpmdComm`` (the counts ride an all-to-all of their own). Its
overflow flags are the rank's own; ``spmd_overflow`` reduces them over the
split group, so that every rank keeps or discards the batch together.

Every capacity is static; exceeding one raises an overflow flag instead of
truncating. Nothing in the loop syncs the host: ``DeviceSampler`` uploads
the targets and layer keys once, and brings the fronts, counts, layers and
flags back in one transfer at the end. It owns the caps: it calibrates them
from one host-sampled batch, doubles a flagged cap at the next epoch boundary
(``refresh_caps``, never mid-epoch), and falls back to the host sampler's
keyed API for the overflowing batch. Draws are keyed by ``(seed, epoch,
batch, layer, vertex, slot)`` (``rng.py``), so results do not depend on
buffer layout or cap sizes (absent overflow).
"""
from __future__ import annotations

import threading

import numpy as np
import torch

import torch.distributed as dist

from repro_torch.core.shuffle import SimComm, SpmdComm
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.sampling import (
    LayerSample,
    MiniBatchSample,
    NeighborSampler,
    sample_minibatch,
)
from repro_torch.kernels.gather_segsum.layout import pow2_at_least
from repro_torch.obs import NULL_OBS
from repro_torch.sampler.frontier import (
    bucket_by_owner,
    sorted_unique_capped,
    take,
)
from repro_torch.sampler.kernel import wavefront_expand
from repro_torch.sampler.ref import INVALID, SELF_LOOP
from repro_torch.sampler.rng import fold_key_pair
from repro_torch.sampler.shard import GraphShards, build_shards, shards_to_device

LAYER_SALT = 0x5A3D  # keyspace tag for per-layer draw keys
CALIB_SALT = 0xCA11B  # throwaway stream for capacity calibration
HEADROOM = 1.5  # calibrated caps: the calibration batch's sizes times this
_EDGE_FIELDS = ("dst", "src", "eid", "valid")


def _decode_edges(front, start, codes, indices, edge_id):
    """Slot codes -> (dst, src, eid, valid) edge arrays, (P, N * fanout).

    ``front``/``start`` are (P, N) per-vertex blocks, ``codes`` (P, N,
    fanout) from the wavefront kernel; ``indices``/``edge_id`` the shard's
    (P, E_cap) CSR payload. Self-loop codes read no CSR slot; invalid codes
    are masked.
    """
    P, N, fanout = codes.shape
    e_cap = indices.shape[1]
    eidl = (start[:, :, None] + codes.clamp(min=0)).clamp(0, e_cap - 1)
    eidl = eidl.reshape(P, N * fanout).long()
    src = torch.gather(indices, 1, eidl)
    eid = torch.gather(edge_id, 1, eidl)
    dst = front[:, :, None].expand(P, N, fanout).reshape(P, N * fanout)
    is_self = (codes == SELF_LOOP).reshape(P, N * fanout)
    src = torch.where(is_self, dst, src)
    eid = torch.where(is_self, -1, eid)
    return dst, src, eid, (codes != INVALID).reshape(P, N * fanout)


def frontier_degrees(dev: dict, front, cnt):
    """For a (P, N) frontier with true counts ``cnt``: the valid-slot mask,
    each vertex's first edge in its owner's shard, and its in-degree (-1
    past the count: the wavefront kernel's invalid row)."""
    V = dev["owner"].shape[0]
    fvalid = torch.arange(front.shape[1], device=front.device)[None] < cnt[:, None]
    lr = take(dev["local_row"], front.clamp(0, V - 1)).long()
    start = torch.gather(dev["indptr"], 1, lr)
    deg = torch.gather(dev["indptr"], 1, lr + 1) - start
    return fvalid, start, torch.where(fvalid, deg, -1)


def _sample_device(dev, targets, n_targets: int, layer_keys, *, caps, fanouts):
    """One mini-batch of cooperative sampling, all P splits on one device.

    dev -- ``shards_to_device`` tensors; targets (B,) int32, zero-padded past
    ``n_targets``; layer_keys (L, 2) int64 (the folded 64-bit layer keys);
    caps -- (name, size) pairs. Returns ``(fronts, counts, layers, flags)``:
    per-depth (P, N_d) sorted frontier blocks and (P,) true counts,
    per-layer (P, N_l * fanout) edge arrays, and per-cap overflow flags, all
    tensors on the shards' device. Syncs nothing.
    """
    caps = dict(caps)
    owner = dev["owner"]
    P = dev["indptr"].shape[0]
    V = owner.shape[0]
    tvalid = torch.arange(targets.shape[0], device=owner.device) < n_targets
    front, cnt, of0 = bucket_by_owner(targets, tvalid, owner, P, caps["N0"], V)
    splits = torch.arange(P, device=owner.device)[:, None]
    return _cooperative_loop(dev, front, cnt, of0, layer_keys, caps, fanouts,
                             splits, P, SimComm())


def sample_minibatch_spmd(dev_local, targets, n_targets: int, layer_keys, *,
                          caps, fanouts, group, num_parts: int):
    """The cooperative loop on one rank of ``group`` (its split group), the
    counterpart of the JAX ``sample_minibatch_spmd``.

    dev_local -- the rank's slice of ``shards_to_device``
    (``launch.sharding.sampler_shard_slice``: its (1, V_cap + 1) ``indptr``
    and (1, E_cap) ``indices``/``edge_id``; ``owner``/``local_row`` whole);
    targets, n_targets, layer_keys as ``_sample_device`` (the full target
    list on every rank); ``num_parts`` P. Its targets are the sorted unique
    ones it owns (``sorted_unique_capped`` under an owner mask, as the JAX
    spmd form has them); the rest is ``_sample_device``'s loop with the
    exchange over ``group``. Returns the rank's ``(fronts, counts, layers,
    flags)`` with a leading axis of 1: split p's rows of ``_sample_device``.
    The flags are this rank's: reduce them with ``spmd_overflow`` before
    deciding to keep the batch (a flagged output is truncated).
    """
    caps = dict(caps)
    owner = dev_local["owner"]
    V = owner.shape[0]
    p = dist.get_rank(group)
    tvalid = (torch.arange(targets.shape[0], device=owner.device) < n_targets) & (
        take(owner, targets.clamp(0, V - 1)) == p)
    front, cnt, of0 = sorted_unique_capped(targets[None], tvalid[None],
                                           caps["N0"], V)
    splits = torch.full((1, 1), p, dtype=owner.dtype, device=owner.device)
    return _cooperative_loop(dev_local, front, cnt, of0.any(), layer_keys,
                             caps, fanouts, splits, num_parts, SpmdComm(group))


def _cooperative_loop(dev, front, cnt, of0, layer_keys, caps, fanouts, splits,
                      num_parts, comm):
    """The per-layer loop from the (S, N0) target fronts of the S splits
    held here (all P in sim form, one on a spmd rank): ``splits`` (S, 1)
    their ids, ``comm`` the frontier exchange."""
    owner = dev["owner"]
    V = owner.shape[0]
    P = num_parts
    device = owner.device
    fronts, counts, layers = [front], [cnt], []
    flags = {"N0": of0}
    for l, fanout in enumerate(fanouts):
        front, cnt = fronts[-1], counts[-1]
        S, N = front.shape
        fvalid, start, deg = frontier_degrees(dev, front, cnt)
        # one flat launch for all splits held here: draws key on global
        # vertex id
        codes = wavefront_expand(
            front.reshape(-1), deg.reshape(-1), layer_keys[l], fanout
        ).reshape(S, N, fanout)
        dst, src, eid, evalid = _decode_edges(
            front, start, codes, dev["indices"], dev["edge_id"]
        )
        layers.append(dict(zip(_EDGE_FIELDS, (dst, src, eid, evalid))))

        # --- cooperative frontier advance -------------------------------
        C, X, N1 = caps[f"C{l}"], caps[f"X{l}"], caps[f"N{l + 1}"]
        cand = torch.cat([src, front], dim=1)
        cvalid = torch.cat([evalid, fvalid], dim=1)
        uniq, ucnt, ofc = sorted_unique_capped(cand, cvalid, C, V)
        uvalid = torch.arange(C, device=device)[None] < ucnt[:, None]
        mine = take(owner, uniq.clamp(0, V - 1)) == splits
        send, scnt, ofx = bucket_by_owner(uniq, uvalid & ~mine, owner, P, X, V)
        # (S, P*X): the ids each owner found for this split; the counts ride
        # the same exchange, (S, P)
        recv = comm.exchange(send)
        rcnt = comm.exchange(scnt[:, :, None])
        rvalid = torch.arange(X, device=device)[None, None] < rcnt[:, :, None]
        merged = torch.cat([uniq, recv], dim=1)
        mvalid = torch.cat([uvalid & mine, rvalid.reshape(S, P * X)], dim=1)
        nf, ncnt, ofn = sorted_unique_capped(merged, mvalid, N1, V)
        flags[f"C{l}"] = ofc.any()
        flags[f"X{l}"] = ofx.any()
        flags[f"N{l + 1}"] = ofn.any()
        fronts.append(nf)
        counts.append(ncnt)
    return fronts, counts, layers, flags


def spmd_overflow(flags: dict, group) -> list:
    """The caps that overflowed on any rank of ``group``: the ranks' flags
    reduced by ``all_reduce(MAX)``, so that every rank takes the same
    keep-or-discard decision (a rank that discarded a batch alone would
    leave its peers waiting in their next collective)."""
    keys = sorted(flags)
    t = torch.stack([flags[k].reshape(()).to(torch.int32) for k in keys])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return [k for k, f in zip(keys, t.tolist()) if f]


def to_host(out):
    """``_sample_device``'s result as numpy arrays, in one device-to-host
    transfer (every piece is cast to int32 and concatenated first)."""
    fronts, counts, layers, flags = out
    keys = sorted(flags)
    pieces = (
        list(fronts) + list(counts)
        + [lay[k] for lay in layers for k in _EDGE_FIELDS]
        + [flags[k] for k in keys]
    )
    flat = torch.cat([p.reshape(-1).to(torch.int32) for p in pieces]).cpu().numpy()
    arrays, at = [], 0
    for p in pieces:
        arrays.append(flat[at:at + p.numel()].reshape(tuple(p.shape)))
        at += p.numel()
    L, D = len(layers), len(fronts)
    it = iter(arrays[2 * D:])
    layers_np = [
        {k: (next(it).astype(bool) if k == "valid" else next(it))
         for k in _EDGE_FIELDS}
        for _ in range(L)
    ]
    flags_np = {k: bool(f) for k, f in zip(keys, arrays[2 * D + 4 * L:])}
    return arrays[:D], arrays[D:2 * D], layers_np, flags_np


class DeviceSampler:
    """Producer-facing facade: device sampling with host-sampler fallback.

    ``device`` holds the shards and runs the loop (``None`` is the card).
    Caps change only in ``refresh_caps`` (called by the plan source at epoch
    boundaries), so the set of batches that overflow, and therefore fall
    back, is a pure function of ``(seed, epoch)``.
    """

    def __init__(
        self,
        graph: CSRGraph,
        assignment: np.ndarray,
        num_devices: int,
        fanouts: list[int],
        seed: int,
        host_sampler: NeighborSampler,
        device=None,
    ):
        self.graph = graph
        self.fanouts = tuple(int(f) for f in fanouts)
        self.seed = seed
        self.host = host_sampler
        self.device = torch.device("cuda" if device is None else device)
        self.shards: GraphShards = build_shards(
            graph, np.asarray(assignment), num_devices
        )
        self._dev = shards_to_device(self.shards, self.device)
        self._lock = threading.Lock()
        self.batches = 0
        self.fallbacks = 0
        self._epoch_base = (0, 0)  # (batches, fallbacks) at last refresh
        self.hwm: dict[str, int] = {}
        self._pending: dict[str, int] = {}
        self._caps = self._calibrate()
        self._streams: dict[str, torch.cuda.Stream] = {}
        # tracing/metrics sink; the trainer re-points this at its own Obs
        self.obs = NULL_OBS

    @property
    def num_devices(self) -> int:
        return self.shards.num_parts

    # ------------------------------------------------------------------ #
    def _cap(self, x: float, limit: int | None = None) -> int:
        c = pow2_at_least(max(int(np.ceil(x)), 1), floor=16)
        if limit is not None:
            c = min(c, pow2_at_least(limit, floor=16))
        return c

    def _calibrate(self) -> dict[str, int]:
        """Size the static caps from one host-sampled batch (+ headroom).

        An underestimate is safe: an overflowing batch falls back to the
        host sampler and the cap doubles at the next epoch boundary.
        """
        P = self.num_devices
        owner = self.shards.owner
        targets = np.asarray(self.host.train_ids[: self.host.batch_size])
        mb = sample_minibatch(
            self.graph, targets, list(self.fanouts),
            np.random.default_rng((self.seed, CALIB_SALT)),
        )
        caps: dict[str, int] = {}
        for d, fr in enumerate(mb.frontiers):
            per_dev = np.bincount(owner[fr], minlength=P)
            caps[f"N{d}"] = self._cap(
                per_dev.max(initial=1) * HEADROOM, limit=self.shards.v_cap
            )
        for l, layer in enumerate(mb.layers):
            dst_o = owner[layer.dst]
            c_max, x_max = 1, 1
            for p in range(P):
                srcs = layer.src[dst_o == p]
                local_front = mb.frontiers[l][owner[mb.frontiers[l]] == p]
                cand = np.unique(np.concatenate([srcs, local_front]))
                c_max = max(c_max, cand.size)
                remote = np.unique(srcs[owner[srcs] != p])
                if remote.size:
                    x_max = max(
                        x_max,
                        int(np.bincount(owner[remote], minlength=P).max()),
                    )
            caps[f"C{l}"] = self._cap(c_max * HEADROOM)
            caps[f"X{l}"] = self._cap(x_max * HEADROOM)
        return caps

    def producer_stream(self) -> torch.cuda.Stream:
        """The CUDA stream the calling producer thread samples on: one a
        thread name, kept for the sampler's life, so a worker slot reuses
        its stream (and the blocks the allocator caches for it) from epoch
        to epoch. On the consumer's stream a producer's one transfer back
        would wait behind the training step."""
        name = threading.current_thread().name
        with self._lock:
            stream = self._streams.get(name)
            if stream is None:
                stream = self._streams[name] = torch.cuda.Stream(self.device)
        return stream

    # ------------------------------------------------------------------ #
    def caps_tuple(self) -> tuple:
        """The current caps as sorted (name, size) pairs."""
        with self._lock:
            return tuple(sorted(self._caps.items()))

    def layer_keys(self, epoch: int, batch: int) -> np.ndarray:
        """Folded per-layer 64-bit draw keys for one batch (uint32, (L, 2))."""
        return np.array(
            [
                fold_key_pair(self.seed, LAYER_SALT, epoch, batch, l)
                for l in range(len(self.fanouts))
            ],
            dtype=np.uint32,
        )

    def device_inputs(self, targets: np.ndarray, epoch: int, batch: int):
        """The targets, zero-padded to a power of two, and the layer keys on
        the sampler's device, in one upload: ``(targets (B,) int32, layer
        keys (L, 2) int64)``."""
        n = targets.shape[0]
        B = pow2_at_least(max(n, 1), floor=16)
        host = np.zeros(B + 2 * len(self.fanouts), np.int64)
        host[:n] = targets
        host[B:] = self.layer_keys(epoch, batch).reshape(-1)
        both = torch.as_tensor(host, device=self.device)
        return both[:B].to(torch.int32), both[B:].reshape(-1, 2)

    def sample_batch(self, targets: np.ndarray, epoch: int, batch: int,
                     replica: int = 0, num_replicas: int = 1) -> MiniBatchSample:
        """Sample one mini-batch on the device, keyed by ``(seed, epoch,
        batch)``.

        On capacity overflow the batch is re-sampled by the host sampler's
        keyed API (the call the host producer would make), the fallback is
        counted (``stats``), and the flagged caps are scheduled to double at
        the next ``refresh_caps``.

        On the 2-D mesh each replica group samples its chunk of the global
        batch: ``(replica, num_replicas)`` fold into the key through the
        flattened counter ``batch * num_replicas + replica``, so the R
        streams are disjoint and each a pure function of integers. The
        defaults leave the key as it was.
        """
        if not 0 <= replica < max(num_replicas, 1):
            raise ValueError(
                f"replica {replica} out of range for R={num_replicas}"
            )
        key_batch = batch * max(num_replicas, 1) + replica
        targets = np.asarray(targets, dtype=np.int64)
        caps = self.caps_tuple()
        t_dev, keys = self.device_inputs(targets, epoch, key_batch)
        fronts, counts, layers, flags = to_host(_sample_device(
            self._dev, t_dev, targets.shape[0], keys, caps=caps,
            fanouts=self.fanouts,
        ))
        overflowed = sorted(k for k, f in flags.items() if f)
        with self._lock:
            self.batches += 1
            for d, c in enumerate(counts):
                k = f"N{d}"
                self.hwm[k] = max(self.hwm.get(k, 0), int(c.max(initial=0)))
            if overflowed:
                self.fallbacks += 1
                for k in overflowed:
                    self._pending[k] = max(
                        self._pending.get(k, 0), 2 * dict(caps)[k]
                    )
        if overflowed:
            # benign (the identical keyed draw on the host) but never silent:
            # the caps were undersized and the batch paid for host sampling
            self.obs.count("fault/sampler_fallback", 1)
            self.obs.instant(
                "fault/sampler_fallback",
                {"epoch": epoch, "batch": key_batch, "caps": overflowed},
            )
            return self.host.sample_batch(targets, epoch, key_batch)
        return self._assemble(targets, fronts, counts, layers)

    def _assemble(self, targets, fronts, counts, layers) -> MiniBatchSample:
        """Device blocks -> the host ``MiniBatchSample`` plan input.

        Per-split frontier blocks are sorted and disjoint (each vertex lives
        only on its owner), so the global sorted-unique frontier is a sort
        of their concatenation.
        """
        P = self.num_devices
        frontiers = []
        for f, c in zip(fronts, counts):
            sel = np.concatenate([f[p, : c[p]] for p in range(P)])
            frontiers.append(np.sort(sel).astype(np.int64))
        out_layers = []
        for lay in layers:
            m = lay["valid"]
            out_layers.append(
                LayerSample(
                    src=lay["src"][m].astype(np.int64),
                    dst=lay["dst"][m].astype(np.int64),
                    edge_id=lay["eid"][m].astype(np.int64),
                )
            )
        return MiniBatchSample(
            target_ids=targets, layers=out_layers, frontiers=frontiers
        )

    # ------------------------------------------------------------------ #
    def refresh_caps(self) -> None:
        """Apply pending capacity growth (epoch boundaries only: growing
        mid-epoch would make fallback decisions order-dependent), and
        snapshot the counters for ``stats``' per-epoch deltas."""
        with self._lock:
            for k, v in self._pending.items():
                self._caps[k] = max(self._caps[k], v)
            self._pending.clear()
            self._epoch_base = (self.batches, self.fallbacks)

    def export_state(self) -> dict:
        """JSON-able capacity/counter state for the checkpoint cursor.

        Caps, pending growth, and the fallback bookkeeping are part of the
        resume contract on the device sources: which batches overflow (and
        so fall back to the host sampler) depends on the capacity table, so
        a bit-exact resume restores it rather than recalibrating.
        """
        with self._lock:
            return {
                "caps": {k: int(v) for k, v in self._caps.items()},
                "pending": {k: int(v) for k, v in self._pending.items()},
                "hwm": {k: int(v) for k, v in self.hwm.items()},
                "batches": int(self.batches),
                "fallbacks": int(self.fallbacks),
                "epoch_base": list(self._epoch_base),
            }

    def load_state(self, state: dict) -> None:
        """Restore ``export_state`` output (checkpoint resume)."""
        with self._lock:
            self._caps = {k: int(v) for k, v in state["caps"].items()}
            self._pending = {k: int(v) for k, v in state["pending"].items()}
            self.hwm = {k: int(v) for k, v in state["hwm"].items()}
            self.batches = int(state["batches"])
            self.fallbacks = int(state["fallbacks"])
            self._epoch_base = tuple(int(x) for x in state["epoch_base"])

    def stats(self) -> dict:
        """Counters and capacity state. ``sampler_batches`` (device sampling
        runs, fallbacks included) and ``sampler_fallbacks`` are
        run-cumulative; the ``sampler_epoch_*`` pair counts since the last
        ``refresh_caps``."""
        with self._lock:
            b0, f0 = self._epoch_base
            return {
                "sampler_batches": self.batches,
                "sampler_fallbacks": self.fallbacks,
                "sampler_epoch_batches": self.batches - b0,
                "sampler_epoch_fallbacks": self.fallbacks - f0,
                "sampler_caps": dict(self._caps),
                "sampler_hwm": dict(self.hwm),
            }
