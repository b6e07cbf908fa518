"""Online mini-batch splitting (paper §4/§5) and shuffle-index construction.

Given a sampled mini-batch and the global partitioning function ``f_G``, the
online splitter maps every sampled vertex to its split in O(1) (a table
lookup — embarrassingly parallel) and builds, per GNN layer, the *shuffle
index*: gather/scatter indices that let devices exchange exactly the hidden
features that cross split boundaries (all-to-all), once per layer, in both
sampling and training (the index is built once and reused, §4).

Device-facing layout (static shapes; see DESIGN.md §3 for the TPU adaptation
of NCCL's variable-size all-to-allv):

  * depth ``i`` = distance from the targets: ``0`` = targets (top),
    ``L`` = input vertices (bottom). ``h[i]`` are the activations at depth
    ``i``; training runs ``i = L -> 0``.
  * per depth, each device owns a padded row block ``(N_i, F)`` holding the
    activations of its *local frontier* (vertices ``v`` with ``f_G[v] == p``).
  * per layer transition ``i`` (depth ``i+1`` sources -> depth ``i`` dsts),
    the *mixed frontier* buffer on device ``p`` is
    ``concat([local rows (N_{i+1}), recv rows (P * S_i)])``; edges address it
    via ``edge_src``. Remote rows arrive via one all-to-all of the
    ``(P, S_i, F)`` send buffer built with ``send_idx``.

Data-parallel micro-batching (the DGL baseline, ``build_dp_plan``) is
expressed in the *same* plan structure with all-local sources and
``S_i = 0``, so one trainer code path serves both paradigms. With a
``ReplicationSet`` the input layer's mixed buffer gains a third region,
``[local][recv][replicated]``, and edges whose source is replicated never
enter the send lists.

A numpy copy of ``repro.core.splitting``: split and dp plans, with or without
the overlap schedule's edge halves and replication, fresh and repadded, are
field-for-field equal to the JAX package's (``tests/test_torch_trainer.py``,
``tests/test_torch_overlap.py``, ``tests/test_torch_replication.py``,
``tests/test_torch_dp.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.graph.sampling import MiniBatchSample
from repro_torch.kernels.gather_segsum.layout import (
    AGG_ROWS,
    layer_layout,
    packed_layout,
)


def pad_axis(a: np.ndarray, axis: int, size: int) -> np.ndarray:
    """Grow one axis to ``size`` with trailing zeros (no-op if big enough).

    The single masked-padding primitive behind all HWM repadding — plans,
    cache plans, and staged host blocks must pad identically for the
    jit-signature machinery to converge.
    """
    if a.shape[axis] >= size:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, size - a.shape[axis])
    return np.pad(a, widths)


def pad_axis_fill(a: np.ndarray, axis: int, size: int, fill: int) -> np.ndarray:
    """``pad_axis`` with an explicit fill — for arrays whose padding value is
    a *sentinel* rather than zero (the packed kernel layout: ``pack_dst``
    pads with the row sentinel R, never 0 = a valid destination row)."""
    if a.shape[axis] >= size:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, size - a.shape[axis])
    return np.pad(a, widths, constant_values=fill)


def pad_axis_edge(a: np.ndarray, axis: int, size: int) -> np.ndarray:
    """``pad_axis`` replicating the trailing value — for CSR offset arrays,
    where appended destinations must read as empty segments (offset ==
    previous offset), not as segments starting at 0."""
    if a.shape[axis] >= size:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, size - a.shape[axis])
    return np.pad(a, widths, mode="edge")


def _roundup(x: int, m: int) -> int:
    """Pad ``x`` up. ``m > 0``: next multiple of m. ``m == -1``: power-of-two
    bucketing (min 16) — bounds the number of distinct jit signatures per
    epoch while keeping padding waste < 2x."""
    if x <= 0:
        return 0
    if m == -1:
        p = 16
        while p < x:
            p <<= 1
        return p
    return ((x + m - 1) // m) * m


@dataclass
class LayerPlan:
    """Shuffle index + aggregation index for one layer transition."""

    edge_src: np.ndarray  # (P, E) int32 into the mixed buffer
    edge_dst: np.ndarray  # (P, E) int32 into the depth-i local block
    edge_mask: np.ndarray  # (P, E) bool
    send_idx: np.ndarray  # (P, P, S) int32: [owner q, needer p, slot]
    send_count: np.ndarray  # (P, P) int32 true (unpadded) send sizes
    self_pos: np.ndarray  # (P, N_i) int32: local row at depth i+1 of each dst
    # Width of the local region of the mixed buffer that ``edge_src`` remote
    # entries (``n_local + q*S + slot``) are currently relative to. Set at
    # build time; ``repad_plan`` rebases the entries and keeps this in sync
    # whenever padding grows the local region or the send width S
    # (DESIGN.md §3, mixed-buffer offset invariant). Required — a wrong
    # value silently corrupts every repadded plan.
    n_local: int
    # --- dst-sorted edge layout (DESIGN.md §3, docs/KERNELS.md) -----------
    # Built once per plan on the producer thread by
    # ``kernels.gather_segsum.layout.layer_layout``; consumed by the fused
    # CUDA aggregation kernels (``agg_backend='fused'``). Repad-stable:
    # ``repad_plan`` grows every axis by pure sentinel appends.
    edge_perm: np.ndarray  # (P, E) int32 permutation: valid dst-sorted first
    seg_offsets: np.ndarray  # (P, N_i + 1) int32 CSR offsets, dst-sorted order
    pack_perm: np.ndarray  # (P, DB, EB) int32 slot -> edge idx (pad: E)
    pack_dst: np.ndarray  # (P, DB, EB) int32 slot -> dst - db*R (pad: R)
    # Rows of the static replicated feature block appended to the mixed
    # buffer *after* the recv region: ``[local (n_local)][recv (P*S)]
    # [replicated (R)]``. Non-zero only on the input layer of plans built
    # with a ``ReplicationSet`` — edges whose src is replicated address
    # ``n_local + P*S + slot`` and never enter the send lists. Static per
    # run (the full set size, not the per-batch occupancy), so repad only
    # ever *moves* the region, never grows it.
    num_replicated: int = 0
    # --- local/remote edge halves (DESIGN.md §3a, overlap schedule) -------
    # The same edge set partitioned by source locality, so the overlapped
    # executor can aggregate the local half from its own row block while the
    # all-to-all for the remote half is still in flight. Each half carries
    # its own edge-order arrays, its position in the full edge axis
    # (``*edge_ids`` — used to slice per-edge quantities like GAT's alpha),
    # and its own repad-stable packed layout for the fused kernels. Local
    # sources index the local block directly (``< n_local``); remote sources
    # are *recv-region relative* (``q*S + slot``), so only send-width growth
    # ever rebases them — never local-region growth. Built only when the
    # plan builder is asked for them (``with_halves`` — the blocking path
    # never pays the construction, repad, or transfer cost); ``None`` means
    # absent, and repad/signature/transfer all skip them consistently.
    ledge_src: np.ndarray | None = None  # (P, EL) int32, [0, n_local)
    ledge_dst: np.ndarray | None = None  # (P, EL) int32 depth-i local rows
    ledge_mask: np.ndarray | None = None  # (P, EL) bool
    ledge_ids: np.ndarray | None = None  # (P, EL) int32 full-edge-axis pos
    lpack_perm: np.ndarray | None = None  # (P, DB, LEB) int32 half-edge idx
    lpack_dst: np.ndarray | None = None  # (P, DB, LEB) int32 dst - db*R
    redge_src: np.ndarray | None = None  # (P, ER) int32 recv region [0,P*S)
    redge_dst: np.ndarray | None = None  # (P, ER) int32
    redge_mask: np.ndarray | None = None  # (P, ER) bool
    redge_ids: np.ndarray | None = None  # (P, ER) int32 full-edge-axis pos
    rpack_perm: np.ndarray | None = None  # (P, DB, REB) int32
    rpack_dst: np.ndarray | None = None  # (P, DB, REB) int32

    @property
    def has_halves(self) -> bool:
        return self.ledge_src is not None

    @property
    def max_send(self) -> int:
        return int(self.send_idx.shape[-1])

    def shuffle_rows(self) -> int:
        """True number of feature rows crossing splits at this layer."""
        return int(self.send_count.sum())


@dataclass
class SplitPlan:
    """A fully-indexed split mini-batch, ready for the jitted step function."""

    num_devices: int
    num_layers: int
    front_ids: list[np.ndarray]  # per depth: (P, N_i) int64 global ids (pad 0)
    node_mask: list[np.ndarray]  # per depth: (P, N_i) bool
    node_count: list[np.ndarray]  # per depth: (P,) int32
    layers: list[LayerPlan]  # len L, index = depth of the dst side
    stats: dict = field(default_factory=dict)

    @property
    def input_ids(self) -> np.ndarray:
        return self.front_ids[-1]

    @property
    def input_mask(self) -> np.ndarray:
        return self.node_mask[-1]

    def loaded_feature_rows(self) -> int:
        """Feature vectors loaded across all devices (dedup'd under split)."""
        return int(self.node_mask[-1].sum())

    def computed_edges(self) -> int:
        return int(sum(l.edge_mask.sum() for l in self.layers))

    def shuffle_rows(self) -> int:
        return sum(l.shuffle_rows() for l in self.layers)

    def padded_edge_slots(self) -> int:
        """Edge slots actually executed by the (padded, vmapped) sim step."""
        return int(sum(l.edge_mask.size for l in self.layers))

    def busiest_edges(self) -> int:
        """True edges on the most-loaded device (the straggler's work)."""
        return self.edge_accounting()[1]

    def load_imbalance(self) -> float:
        """max/mean edges per split across layers l>0 (paper Fig. 5 metric)."""
        return self.edge_accounting()[2]

    def cross_edge_fraction(self) -> float:
        """Cross-split edges / total edges (paper Fig. 5 metric)."""
        return self.edge_accounting()[3]

    def edge_accounting(self) -> tuple[int, int, float, float]:
        """``(computed_edges, busiest_edges, load_imbalance,
        cross_edge_fraction)`` from one pass over the layers' edge masks, as
        the trainer reads them after every step."""
        per_dev = np.zeros(self.num_devices, dtype=np.int64)
        cross = 0
        for l in self.layers:
            per_dev += l.edge_mask.sum(axis=1)
            # an edge is cross-split iff its src addresses the recv region
            # ``[n_local, n_local + P*S)``; the boundary is the layer's
            # recorded n_local (== the current front width only because
            # repad keeps the two in sync — using the front shape directly
            # undercounted on repadded plans). Sources *beyond* the recv
            # region address the static replicated block: they are served
            # locally on every split and put nothing on the wire, so they do
            # not count as cross.
            recv_end = l.n_local + self.num_devices * l.max_send
            cross += int(
                (
                    (l.edge_src >= l.n_local)
                    & (l.edge_src < recv_end)
                    & l.edge_mask
                ).sum()
            )
        total = int(per_dev.sum())
        busiest = int(per_dev.max())
        mean = per_dev.mean()
        imbalance = float(per_dev.max() / mean) if mean > 0 else 1.0
        return total, busiest, imbalance, (cross / total if total else 0.0)


def _group_by_owner(frontier: np.ndarray, owner_of: np.ndarray, num_devices: int):
    """Group a sorted-unique frontier by owner.

    Returns (owner, local_idx, counts): per frontier position, its owning
    device and its row within that device's local block; counts per device.
    """
    owner = owner_of[frontier].astype(np.int32)
    counts = np.bincount(owner, minlength=num_devices).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    order = np.argsort(owner, kind="stable")
    local_idx = np.empty(frontier.shape[0], dtype=np.int64)
    local_idx[order] = np.arange(frontier.shape[0]) - np.repeat(starts, counts)
    return owner, local_idx, counts


def split_edge_halves(
    edge_src: np.ndarray,  # (P, E) int32, mixed-buffer coordinates
    edge_dst: np.ndarray,  # (P, E) int32
    edge_mask: np.ndarray,  # (P, E) bool
    n_local: int,
    num_out: int,
    pad_multiple: int = 8,
    recv_width: int | None = None,
) -> dict:
    """Partition a layer's edge set into local-src and remote-src halves.

    Every valid edge lands in exactly one half; the halves are compacted per
    device and padded to bucketed widths ``EL``/``ER``. Remote sources are
    stored *recv-region relative* (``edge_src - n_local``), making them
    invariant under local-region growth — ``repad_plan`` only rebases them
    when the send width S grows. Returns the ``LayerPlan`` half fields (see
    the dataclass) including the per-half packed layouts for the fused
    kernels.

    ``recv_width`` bounds the recv region (``P * S``): sources at or beyond
    ``n_local + recv_width`` address the static *replicated* block, which is
    device-resident — so they belong to the **local** half (they need no
    exchange), with their coordinates compacted onto the local half's source
    space ``concat([local rows, replicated rows])`` (i.e. ``recv_width`` is
    subtracted). ``None`` keeps the two-way split, which is identical
    whenever no source lies beyond the recv region.
    """
    P, _ = edge_src.shape

    def one_half(sel: np.ndarray, vals: np.ndarray) -> tuple:
        counts = sel.sum(axis=1)
        W = _roundup(int(counts.max()), pad_multiple)
        src = np.zeros((P, W), dtype=np.int32)
        dst = np.zeros((P, W), dtype=np.int32)
        mask = np.zeros((P, W), dtype=bool)
        ids = np.zeros((P, W), dtype=np.int32)
        for p in range(P):
            idx = np.flatnonzero(sel[p])
            k = idx.shape[0]
            ids[p, :k] = idx
            src[p, :k] = vals[p, idx]
            dst[p, :k] = edge_dst[p, idx]
            mask[p, :k] = True
        pack_perm, pack_dst = packed_layout(dst, mask, num_out)
        return src, dst, mask, ids, pack_perm, pack_dst

    if recv_width is None:
        local_sel = edge_mask & (edge_src < n_local)
        local_vals = edge_src
        remote_sel = edge_mask & (edge_src >= n_local)
    else:
        recv_end = n_local + recv_width
        is_rep = edge_src >= recv_end
        local_sel = edge_mask & ((edge_src < n_local) | is_rep)
        # replicated srcs compact onto [n_local, n_local + R) of the local
        # half's concat([local rows, replicated rows]) source space
        local_vals = np.where(is_rep, edge_src - recv_width, edge_src)
        remote_sel = edge_mask & (edge_src >= n_local) & ~is_rep
    local = one_half(local_sel, local_vals)
    remote = one_half(remote_sel, edge_src - n_local)
    return {
        "ledge_src": local[0],
        "ledge_dst": local[1],
        "ledge_mask": local[2],
        "ledge_ids": local[3],
        "lpack_perm": local[4],
        "lpack_dst": local[5],
        "redge_src": remote[0],
        "redge_dst": remote[1],
        "redge_mask": remote[2],
        "redge_ids": remote[3],
        "rpack_perm": remote[4],
        "rpack_dst": remote[5],
    }


def build_split_plan(
    sample: MiniBatchSample,
    assignment: np.ndarray,
    num_devices: int,
    pad_multiple: int = 8,
    with_halves: bool = False,
    replication=None,  # core.partition.ReplicationSet | None
) -> SplitPlan:
    """Split a sampled mini-batch with f_G = ``assignment`` (the online part).

    Everything here is O(|sample|) with vectorized numpy — the per-vertex
    mapping is a constant-time lookup, matching the paper's requirement that
    splitting runs on-the-fly at every iteration.

    With a ``replication`` set, *input-layer* edges whose src is replicated
    are local on every split: they are dropped from the send lists (the
    all-to-all never carries their rows) and their ``edge_src`` is rerouted
    to the replicated region of the mixed buffer,
    ``n_local + P*S + slot_of[src]``. The rule is uniform — owner-local
    edges with a replicated src reroute too, which is bit-identical (the
    replicated block holds the same fp32 rows as the loaded features) and
    keeps the plan a pure function of (sample, assignment, replication).
    Only the input layer qualifies: deeper frontiers carry *computed*
    hidden activations, which a remote split could only serve by redundantly
    recomputing the vertex's whole subtree — a net traffic loss.
    """
    P = num_devices
    L = sample.num_layers

    owners: list[np.ndarray] = []
    locals_: list[np.ndarray] = []
    counts: list[np.ndarray] = []
    for depth in range(L + 1):
        o, li, c = _group_by_owner(sample.frontiers[depth], assignment, P)
        owners.append(o)
        locals_.append(li)
        counts.append(c)

    front_size = [
        _roundup(max(int(c.max()), 1), pad_multiple) for c in counts
    ]

    front_ids, node_mask, node_count = [], [], []
    for depth in range(L + 1):
        N = front_size[depth]
        ids = np.zeros((P, N), dtype=np.int64)
        mask = np.zeros((P, N), dtype=bool)
        fr = sample.frontiers[depth]
        ids[owners[depth], locals_[depth]] = fr
        mask[owners[depth], locals_[depth]] = True
        front_ids.append(ids)
        node_mask.append(mask)
        node_count.append(counts[depth].astype(np.int32))

    def pos_of(depth: int, verts: np.ndarray):
        """(owner, local_idx) of global ids ``verts`` within depth's frontier."""
        j = np.searchsorted(sample.frontiers[depth], verts)
        return owners[depth][j], locals_[depth][j]

    layer_plans: list[LayerPlan] = []
    for i in range(L):
        layer = sample.layers[i]
        dst_owner, dst_local = pos_of(i, layer.dst)
        src_owner, src_local = pos_of(i + 1, layer.src)
        n_local = front_size[i + 1]

        # replication applies to the input layer only (depth-L sources are
        # the statically servable feature rows); R is the *full* set size —
        # a static region width, independent of per-batch occupancy
        bottom = i == L - 1
        if replication is not None and bottom:
            rep_slot = replication.slot_of[layer.src].astype(np.int64)
            is_rep = rep_slot >= 0
            num_rep = replication.num_replicated
        else:
            is_rep = np.zeros(layer.src.shape[0], dtype=bool)
            num_rep = 0

        # ---- build send lists: unique (owner q, needer p, vertex) ----------
        remote = (src_owner != dst_owner) & ~is_rep
        r_q = src_owner[remote].astype(np.int64)
        r_p = dst_owner[remote].astype(np.int64)
        r_v = layer.src[remote]
        key = (r_q * P + r_p) * (sample.frontiers[i + 1][-1] + 1 if r_v.size else 1) + r_v
        uniq_key, inv = np.unique(key, return_inverse=True)
        # slot of each unique row within its (q, p) group
        uq = uniq_key // (sample.frontiers[i + 1][-1] + 1 if r_v.size else 1)
        u_q = (uq // P).astype(np.int64)
        u_p = (uq % P).astype(np.int64)
        pair = u_q * P + u_p
        pair_counts = np.bincount(pair, minlength=P * P)
        pair_starts = np.concatenate([[0], np.cumsum(pair_counts)[:-1]])
        slot = np.arange(uniq_key.shape[0]) - pair_starts[pair]  # uniq sorted by key
        S = max(int(pair_counts.max(initial=0)), 0)
        S = _roundup(S, pad_multiple) if S else 0

        send_idx = np.zeros((P, P, max(S, 1)), dtype=np.int32)[:, :, :S]
        send_count = pair_counts.reshape(P, P).astype(np.int32)
        if uniq_key.size:
            # local row (on owner q) of each unique sent vertex
            u_v = uniq_key % (sample.frontiers[i + 1][-1] + 1)
            _, u_local = pos_of(i + 1, u_v)
            send_idx[u_q, u_p, slot] = u_local.astype(np.int32)

        # ---- edge source positions in the mixed buffer ---------------------
        src_pos = src_local.astype(np.int64).copy()
        if remote.any():
            recv_slot = slot[inv]  # slot of each remote edge's vertex
            src_pos[remote] = n_local + r_q * S + recv_slot
        if is_rep.any():
            # replicated srcs address the static block after the recv region
            src_pos[is_rep] = n_local + P * S + rep_slot[is_rep]
        E = _roundup(max(layer.num_edges, 1), pad_multiple)
        edge_src = np.zeros((P, E), dtype=np.int32)
        edge_dst = np.zeros((P, E), dtype=np.int32)
        edge_mask = np.zeros((P, E), dtype=bool)
        # pack edges per destination device
        e_owner = dst_owner.astype(np.int64)
        e_counts = np.bincount(e_owner, minlength=P)
        e_starts = np.concatenate([[0], np.cumsum(e_counts)[:-1]])
        order = np.argsort(e_owner, kind="stable")
        within = np.arange(layer.num_edges) - np.repeat(e_starts, e_counts)
        edge_src[e_owner[order], within] = src_pos[order].astype(np.int32)
        edge_dst[e_owner[order], within] = dst_local[order].astype(np.int32)
        edge_mask[e_owner[order], within] = True
        E_max = max(int(e_counts.max(initial=0)), 1)
        E_pad = _roundup(E_max, pad_multiple)
        edge_src = edge_src[:, :E_pad]
        edge_dst = edge_dst[:, :E_pad]
        edge_mask = edge_mask[:, :E_pad]

        # ---- self positions: row of each depth-i vertex at depth i+1 -------
        fr = sample.frontiers[i]
        _, self_local = pos_of(i + 1, fr)  # same owner by construction
        self_pos = np.zeros((P, front_size[i]), dtype=np.int32)
        self_pos[owners[i], locals_[i]] = self_local.astype(np.int32)

        layer_plans.append(
            LayerPlan(
                edge_src=edge_src,
                edge_dst=edge_dst,
                edge_mask=edge_mask,
                send_idx=send_idx,
                send_count=send_count,
                self_pos=self_pos,
                n_local=n_local,
                num_replicated=num_rep,
                **layer_layout(edge_dst, edge_mask, front_size[i]),
                **(
                    split_edge_halves(
                        edge_src, edge_dst, edge_mask, n_local,
                        front_size[i], pad_multiple,
                        recv_width=P * S,
                    )
                    if with_halves
                    else {}
                ),
            )
        )

    plan = SplitPlan(
        num_devices=P,
        num_layers=L,
        front_ids=front_ids,
        node_mask=node_mask,
        node_count=node_count,
        layers=layer_plans,
    )
    plan.stats = {
        "loaded_rows": plan.loaded_feature_rows(),
        "edges": plan.computed_edges(),
        "shuffle_rows": plan.shuffle_rows(),
    }
    return plan


def build_dp_plan(
    samples: list[MiniBatchSample],
    pad_multiple: int = 8,
    with_halves: bool = False,
) -> SplitPlan:
    """Stack independent micro-batches into the split-plan layout.

    This is the data-parallel baseline: every source is local (redundant
    loads/compute included), ``S_i = 0`` so no shuffles are emitted.
    """
    P = len(samples)
    L = samples[0].num_layers
    assert all(s.num_layers == L for s in samples)

    front_size = [
        _roundup(max(max(s.frontiers[d].shape[0] for s in samples), 1), pad_multiple)
        for d in range(L + 1)
    ]
    front_ids, node_mask, node_count = [], [], []
    for d in range(L + 1):
        N = front_size[d]
        ids = np.zeros((P, N), dtype=np.int64)
        mask = np.zeros((P, N), dtype=bool)
        cnt = np.zeros(P, dtype=np.int32)
        for p, s in enumerate(samples):
            k = s.frontiers[d].shape[0]
            ids[p, :k] = s.frontiers[d]
            mask[p, :k] = True
            cnt[p] = k
        front_ids.append(ids)
        node_mask.append(mask)
        node_count.append(cnt)

    layer_plans = []
    for i in range(L):
        E = _roundup(max(max(s.layers[i].num_edges for s in samples), 1), pad_multiple)
        edge_src = np.zeros((P, E), dtype=np.int32)
        edge_dst = np.zeros((P, E), dtype=np.int32)
        edge_mask = np.zeros((P, E), dtype=bool)
        self_pos = np.zeros((P, front_size[i]), dtype=np.int32)
        for p, s in enumerate(samples):
            layer = s.layers[i]
            k = layer.num_edges
            edge_src[p, :k] = np.searchsorted(s.frontiers[i + 1], layer.src)
            edge_dst[p, :k] = np.searchsorted(s.frontiers[i], layer.dst)
            edge_mask[p, :k] = True
            fr = s.frontiers[i]
            self_pos[p, : fr.shape[0]] = np.searchsorted(s.frontiers[i + 1], fr)
        layer_plans.append(
            LayerPlan(
                edge_src=edge_src,
                edge_dst=edge_dst,
                edge_mask=edge_mask,
                send_idx=np.zeros((P, P, 0), dtype=np.int32),
                send_count=np.zeros((P, P), dtype=np.int32),
                self_pos=self_pos,
                n_local=front_size[i + 1],
                **layer_layout(edge_dst, edge_mask, front_size[i]),
                **(
                    split_edge_halves(
                        edge_src, edge_dst, edge_mask, front_size[i + 1],
                        front_size[i], pad_multiple,
                    )
                    if with_halves
                    else {}
                ),
            )
        )

    plan = SplitPlan(
        num_devices=P,
        num_layers=L,
        front_ids=front_ids,
        node_mask=node_mask,
        node_count=node_count,
        layers=layer_plans,
    )
    plan.stats = {
        "loaded_rows": plan.loaded_feature_rows(),
        "edges": plan.computed_edges(),
        "shuffle_rows": 0,
    }
    return plan


def repad_plan(plan: SplitPlan, hwm: dict) -> SplitPlan:
    """Re-pad a plan's arrays up to running high-water marks (in place).

    Keeps the jitted step's shape signature stable across iterations: after
    the first few batches every plan reuses the same compiled executable
    (padding rows/edges are masked, so numerics are unchanged).

    The ``hwm`` dict is *order-sensitive* shared state: which batch first
    raises a mark determines every later batch's padded shapes. The runtime
    therefore applies it on the ordered (delivery) side of the prefetch
    queue, never in producer threads — see ``runtime.plan_source._finalize``
    and DESIGN.md §6.
    """

    for d in range(plan.num_layers + 1):
        key = f"N{d}"
        hwm[key] = max(hwm.get(key, 0), plan.front_ids[d].shape[1])
        plan.front_ids[d] = pad_axis(plan.front_ids[d], 1, hwm[key])
        plan.node_mask[d] = pad_axis(plan.node_mask[d], 1, hwm[key])
    for i, lp in enumerate(plan.layers):
        ek = f"E{i}"
        hwm[ek] = max(hwm.get(ek, 0), lp.edge_src.shape[1])
        old_e = lp.edge_perm.shape[1]
        lp.edge_src = pad_axis(lp.edge_src, 1, hwm[ek])
        lp.edge_dst = pad_axis(lp.edge_dst, 1, hwm[ek])
        lp.edge_mask = pad_axis(lp.edge_mask, 1, hwm[ek])
        # dst-sorted layout, edge axis: the permutation must stay a true
        # permutation of [0, E), so the appended (masked) edge slots join its
        # tail in order. seg_offsets index *sorted positions* of valid edges
        # only — edge growth leaves them untouched. pack_perm entries that
        # held the old sentinel E now point at masked edge slots, which the
        # kernels ignore (padding is marked by pack_dst == R alone).
        new_e = hwm[ek]
        if new_e > old_e:
            P = lp.edge_perm.shape[0]
            extra = np.broadcast_to(
                np.arange(old_e, new_e, dtype=np.int32), (P, new_e - old_e)
            )
            lp.edge_perm = np.concatenate([lp.edge_perm, extra], axis=1)
        sk = f"S{i}"
        old_s = lp.send_idx.shape[2]
        hwm[sk] = max(hwm.get(sk, 0), old_s)
        new_s = hwm[sk]
        # Remote edge_src entries encode ``n_local + q*S + slot`` against the
        # pre-repad layout; replicated entries encode
        # ``n_local + P*S + rep_slot`` just past it. Growing the local
        # region (N_{i+1}) or the send width (S) moves both regions, so
        # rebase each onto the new layout — otherwise they address zeroed
        # padding rows and split-mode aggregation silently drops every
        # cross-split (or replicated) edge. The replicated region's width R
        # is static, so its entries only *shift* by the region's new start.
        old_n = lp.n_local
        new_n = plan.front_ids[i + 1].shape[1]  # already padded to hwm[N{i+1}]
        num_dev = lp.edge_src.shape[0]
        if (old_s > 0 or lp.num_replicated > 0) and (
            new_n != old_n or new_s != old_s
        ):
            old_recv_end = old_n + num_dev * old_s
            rep = lp.edge_src >= old_recv_end  # empty when num_replicated=0
            remote = (lp.edge_src >= old_n) & ~rep
            if old_s > 0 and remote.any():
                q, slot = np.divmod(
                    lp.edge_src[remote].astype(np.int64) - old_n, old_s
                )
                lp.edge_src[remote] = (new_n + q * new_s + slot).astype(np.int32)
            if rep.any():
                shift = (new_n + num_dev * new_s) - old_recv_end
                lp.edge_src[rep] += np.int32(shift)
        lp.n_local = new_n
        lp.send_idx = pad_axis(lp.send_idx, 2, new_s)
        nk = f"N{i}"
        lp.self_pos = pad_axis(lp.self_pos, 1, hwm[nk])
        # dst-sorted layout, destination axis: appended dst rows are empty
        # segments (replicate the final CSR offset) and empty packed blocks
        # (sentinel fills — R for pack_dst, never 0, which is a valid row).
        # Growing the per-block width EB appends sentinel slots inside each
        # block; all three are pure appends, so no rebase is ever needed
        # (the §3 dst-sorted-layout invariant).
        new_ni = hwm[nk]
        lp.seg_offsets = pad_axis_edge(lp.seg_offsets, 1, new_ni + 1)
        ebk = f"EB{i}"
        hwm[ebk] = max(hwm.get(ebk, 0), lp.pack_perm.shape[2])
        new_db = max(-(-new_ni // AGG_ROWS), 1)
        lp.pack_perm = pad_axis_fill(lp.pack_perm, 2, hwm[ebk], new_e)
        lp.pack_perm = pad_axis_fill(lp.pack_perm, 1, new_db, new_e)
        lp.pack_dst = pad_axis_fill(lp.pack_dst, 2, hwm[ebk], AGG_ROWS)
        lp.pack_dst = pad_axis_fill(lp.pack_dst, 1, new_db, AGG_ROWS)
        # --- local/remote halves (overlap schedule, DESIGN.md §3a) --------
        # Edge-axis growth is pure masked appends for both halves. Local
        # sources index the local block, whose rows never move; remote
        # sources are recv-region relative (q*S + slot), so only send-width
        # growth rebases them — exactly the slot re-encoding applied to the
        # full edge_src above, minus the n_local offset. Plans built without
        # halves (blocking path) skip this block and never create the
        # EL/ER/LEB/REB marks.
        if not lp.has_halves:
            continue
        for side in ("l", "r"):
            hk = f"E{side.upper()}{i}"
            width = getattr(lp, f"{side}edge_src").shape[1]
            hwm[hk] = max(hwm.get(hk, 0), width)
            if side == "r" and old_s > 0 and new_s != old_s:
                q, slot = np.divmod(lp.redge_src.astype(np.int64), old_s)
                lp.redge_src = (q * new_s + slot).astype(np.int32)
            if side == "l" and lp.num_replicated > 0 and new_n != old_n:
                # local-half sources live in concat([local rows, replicated
                # rows]): entries >= old n_local are replicated-block rows
                # and shift with the local region's growth (masked padding
                # slots are zeros, hence < old_n, hence untouched)
                lrep = lp.ledge_src >= old_n
                if lrep.any():
                    lp.ledge_src[lrep] += np.int32(new_n - old_n)
            for name in ("edge_src", "edge_dst", "edge_mask", "edge_ids"):
                attr = f"{side}{name}"
                setattr(lp, attr, pad_axis(getattr(lp, attr), 1, hwm[hk]))
            pbk = f"{side.upper()}EB{i}"
            perm = getattr(lp, f"{side}pack_perm")
            dst = getattr(lp, f"{side}pack_dst")
            hwm[pbk] = max(hwm.get(pbk, 0), perm.shape[2])
            perm = pad_axis_fill(perm, 2, hwm[pbk], hwm[hk])
            perm = pad_axis_fill(perm, 1, new_db, hwm[hk])
            dst = pad_axis_fill(dst, 2, hwm[pbk], AGG_ROWS)
            dst = pad_axis_fill(dst, 1, new_db, AGG_ROWS)
            setattr(lp, f"{side}pack_perm", perm)
            setattr(lp, f"{side}pack_dst", dst)
    return plan
