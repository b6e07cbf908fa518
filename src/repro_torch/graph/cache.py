"""Static device-resident feature caches (paper §2.2 / §7.1), a copy of
``repro.graph.cache``.

All variants rank vertices by pre-sampling access frequency (the criterion of
GNNLab [41], used by both Quiver and GSplit in the paper) and differ in
*placement*:

  * ``partitioned``  (GSplit): top-ranked vertices of partition ``p`` cached
    on device ``p`` — consistent with the splits, so every cache hit is local.
  * ``distributed``  (Quiver): global top-ranked vertices sharded across
    devices — a hit may be remote (NVLink peer fetch).
  * ``none``         (DGL on large graphs): no cache, every load is a host miss.

The cache is *served*, not just counted: ``build_resident`` materializes a
``(P, C, F)`` row block that the trainer keeps on the device for the whole
run, and ``build_plan`` compiles, per mini-batch, a ``CachePlan`` — the
gather/scatter recipe that assembles the input-feature block from three
sources inside the step (``core.shuffle.sim_serve_features``):

  1. local hits   — rows gathered from the device's own resident block,
  2. remote hits  — rows fetched from peer blocks through the same all-to-all
                    as the layer shuffles (``distributed`` mode),
  3. host misses  — a *compacted* host gather of only the uncached rows,
                    scattered into place on the device.

Every position of the input frontier is covered by exactly one source, and
sources are combined by scatter-*add* into a zero block, so the served
result equals a full host gather (``plan_io.load_features``) and stays exact
under high-water-mark repadding (positions never shift — repad only appends
masked padding). Numpy only; the plans it builds are equal to the JAX
package's bit for bit (``tests/test_torch_cache.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.splitting import SplitPlan, _roundup, pad_axis


@dataclass
class LoadBreakdown:
    local_hit: int
    remote_hit: int
    host_miss: int

    @property
    def total(self) -> int:
        return self.local_hit + self.remote_hit + self.host_miss


@dataclass
class CachePlan:
    """Per-batch serving recipe for the input-feature block (device-shaped).

    ``N`` is the padded input-frontier width, ``C`` the resident block rows,
    ``Sc`` the cache-shuffle send width, ``M`` the compacted miss width. All
    index arrays are position-based (rows never encode layout offsets), so
    the plan is repad-stable: ``pad_to`` only appends masked entries.
    """

    local_slot: np.ndarray  # (P, N) int32 row in own resident block (0 if n/a)
    local_mask: np.ndarray  # (P, N) bool: position is a local hit
    send_slot: np.ndarray  # (P, P, Sc) int32 [owner q, needer p, s]: row in q's block
    recv_pos: np.ndarray  # (P, P, Sc) int32 [needer p, owner q, s]: dest row on p
    recv_mask: np.ndarray  # (P, P, Sc) bool [needer p, owner q, s]
    miss_ids: np.ndarray  # (P, M) int64 global ids to host-gather (0-padded)
    miss_pos: np.ndarray  # (P, M) int32 dest row of each miss
    miss_mask: np.ndarray  # (P, M) bool

    @property
    def max_send(self) -> int:
        return int(self.send_slot.shape[-1])

    @property
    def max_miss(self) -> int:
        return int(self.miss_ids.shape[-1])

    def breakdown(self) -> LoadBreakdown:
        return LoadBreakdown(
            local_hit=int(self.local_mask.sum()),
            remote_hit=int(self.recv_mask.sum()),
            host_miss=int(self.miss_mask.sum()),
        )

    def pad_to(self, n: int, m: int, s: int) -> "CachePlan":
        """Grow to padded widths (in place) — delivery-side, like repad_plan."""
        self.local_slot = pad_axis(self.local_slot, 1, n)
        self.local_mask = pad_axis(self.local_mask, 1, n)
        self.send_slot = pad_axis(self.send_slot, 2, s)
        self.recv_pos = pad_axis(self.recv_pos, 2, s)
        self.recv_mask = pad_axis(self.recv_mask, 2, s)
        self.miss_ids = pad_axis(self.miss_ids, 1, m)
        self.miss_pos = pad_axis(self.miss_pos, 1, m)
        self.miss_mask = pad_axis(self.miss_mask, 1, m)
        return self


class FeatureCache:
    def __init__(
        self,
        num_nodes: int,
        num_devices: int,
        capacity_per_device: int,
        ranking: np.ndarray,  # e.g. presample vertex_weight (higher = cache first)
        mode: str = "distributed",
        partition_assignment: np.ndarray | None = None,
    ):
        self.num_devices = num_devices
        self.mode = mode
        # cached_on[v] = device holding v's features, or -1
        # cache_slot[v] = row of v within that device's resident block
        self.cached_on = np.full(num_nodes, -1, dtype=np.int32)
        self.cache_slot = np.zeros(num_nodes, dtype=np.int32)
        self._serves = False
        if mode == "none" or capacity_per_device == 0:
            return
        if mode == "distributed":
            order = np.argsort(-ranking, kind="stable")
            top = order[: capacity_per_device * num_devices]
            pos = np.arange(top.shape[0])
            self.cached_on[top] = pos % num_devices
            self.cache_slot[top] = pos // num_devices
        elif mode == "partitioned":
            assert partition_assignment is not None
            for p in range(num_devices):
                members = np.flatnonzero(partition_assignment == p)
                order = members[np.argsort(-ranking[members], kind="stable")]
                kept = order[:capacity_per_device]
                self.cached_on[kept] = p
                self.cache_slot[kept] = np.arange(kept.shape[0])
        else:
            raise ValueError(f"unknown cache mode {mode!r}")
        self._serves = bool((self.cached_on >= 0).any())

    @property
    def serves(self) -> bool:
        """Whether a resident block exists to serve hits from (static)."""
        return self._serves

    @property
    def block_rows(self) -> int:
        """Rows C of the per-device resident block (max occupancy, min 1)."""
        if not self.serves:
            return 1
        return int(self.cache_slot[self.cached_on >= 0].max()) + 1

    def build_resident(self, features: np.ndarray) -> np.ndarray:
        """Materialize the (P, C, F) resident block (trainer setup, once)."""
        C = self.block_rows
        block = np.zeros(
            (self.num_devices, C, features.shape[1]), dtype=np.float32
        )
        cached = np.flatnonzero(self.cached_on >= 0)
        block[self.cached_on[cached], self.cache_slot[cached]] = features[cached]
        return block

    def _classify(self, plan: SplitPlan):
        """(where, local, remote, miss) masks over the input frontier.

        The single definition of the hit/miss taxonomy — the serving plan
        and the accounting counts must never disagree.
        """
        ids = plan.front_ids[-1]  # (P, N_L)
        mask = plan.node_mask[-1]
        where = self.cached_on[ids]  # (P, N_L)
        dev = np.arange(ids.shape[0], dtype=np.int32)[:, None]
        local = (where == dev) & mask
        remote = (where >= 0) & (where != dev) & mask
        miss = (where < 0) & mask
        return where, local, remote, miss

    def build_plan(self, plan: SplitPlan, pad_multiple: int = 8) -> CachePlan:
        """Compile the serving recipe for one plan's input frontier.

        Pure reads over static tables plus O(|frontier|) grouping, so the
        pipelined runtime may call it from any producer thread. Widths are
        ``_roundup``-bucketed like every other plan dimension; delivery-side
        repadding (``CachePlan.pad_to``) grows them to high-water marks.
        """
        ids = plan.front_ids[-1]  # (P, N_L)
        P, N = ids.shape
        slot = self.cache_slot[ids]
        where, local, remote, miss = self._classify(plan)

        local_slot = np.where(local, slot, 0).astype(np.int32)

        # ---- remote hits: one all-to-all row per (owner q -> needer p) -----
        flat = np.flatnonzero(remote)
        r_q = where.reshape(-1)[flat].astype(np.int64)  # owner
        r_p = flat // N  # needer
        r_j = (flat % N).astype(np.int32)  # dest row on the needer
        pair = r_q * P + r_p
        pair_counts = np.bincount(pair, minlength=P * P)
        Sc = int(pair_counts.max(initial=0))
        Sc = _roundup(Sc, pad_multiple) if Sc else 0
        send_slot = np.zeros((P, P, Sc), dtype=np.int32)
        recv_pos = np.zeros((P, P, Sc), dtype=np.int32)
        recv_mask = np.zeros((P, P, Sc), dtype=bool)
        if flat.size:
            pair_starts = np.concatenate([[0], np.cumsum(pair_counts)[:-1]])
            order = np.argsort(pair, kind="stable")
            within = np.arange(flat.size) - np.repeat(
                pair_starts, pair_counts
            )
            oq, op, ow = r_q[order], r_p[order], within
            send_slot[oq, op, ow] = slot.reshape(-1)[flat][order]
            recv_pos[op, oq, ow] = r_j[order]  # needer-major, matches recv
            recv_mask[op, oq, ow] = True

        # ---- host misses: compacted gather list per device -----------------
        miss_counts = miss.sum(axis=1)
        M = int(miss_counts.max(initial=0))
        M = _roundup(M, pad_multiple) if M else 0
        miss_ids = np.zeros((P, M), dtype=np.int64)
        miss_pos = np.zeros((P, M), dtype=np.int32)
        miss_mask = np.zeros((P, M), dtype=bool)
        for p in range(P):
            j = np.flatnonzero(miss[p])
            miss_ids[p, : j.size] = ids[p, j]
            miss_pos[p, : j.size] = j
            miss_mask[p, : j.size] = True

        return CachePlan(
            local_slot=local_slot,
            local_mask=local,
            send_slot=send_slot,
            recv_pos=recv_pos,
            recv_mask=recv_mask,
            miss_ids=miss_ids,
            miss_pos=miss_pos,
            miss_mask=miss_mask,
        )

    def classify_plan(self, plan: SplitPlan) -> LoadBreakdown:
        """Count where each required input-feature row would be served from.

        Pure reads over static tables (vectorized over the whole (P, N_L)
        block), so the pipelined runtime may call it from any producer
        thread without locking.
        """
        _, local, remote, miss = self._classify(plan)
        return LoadBreakdown(
            local_hit=int(local.sum()),
            remote_hit=int(remote.sum()),
            host_miss=int(miss.sum()),
        )
