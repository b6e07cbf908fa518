"""Weighted min-edge-cut graph partitioning (Eq. 2 of the paper).

The paper uses METIS offline; METIS is not available here, so we implement a
two-stage heuristic with the same objective:

  1. **LDG streaming placement** (linear deterministic greedy): visit vertices
     in a degree-descending order; place ``v`` on the partition maximizing
     ``(edge weight to partition) * (1 - load/capacity)``.
  2. **Boundary refinement** (Kernighan–Lin/FM-style): repeated vectorized
     passes computing, for every vertex, its connection weight to each
     partition; greedily apply positive-gain moves that keep the
     ``(1 + eps)`` balance constraint.

Partitioner variants used by the paper's ablation (§7.3):

  * ``gsplit``    -- pre-sampled vertex AND edge weights (probabilistic
                     guarantees)
  * ``node``      -- pre-sampled vertex weights, uniform edge weights
  * ``edge``      -- no pre-sampling: balances edges + target vertices per
                     partition while min-cutting unweighted edges
  * ``rand``      -- uniform random assignment
  * ``telemetry`` -- the gsplit objective driven by *empirical* per-batch
                     counts recorded during training (``EdgeTelemetry``)
                     instead of the offline presample estimates

A numpy copy of ``repro.core.partition`` (the port imports nothing of the
JAX package): the five methods, hot-vertex replication
(``select_replication``), the telemetry accumulator and
``refine_partition`` give bitwise-equal results for the same inputs
(``tests/test_torch_replication.py``).

Cut convention (used consistently by ``Partition.cut_weight``, the
multi-start ``best_cut`` selection, and ``_refine``): the cut is the sum of
``w_E(e)`` over all *directed CSR edges* whose endpoints live on different
partitions. Symmetrized graphs therefore count each undirected edge once per
direction — deliberately, because the presampled ``k_e`` weights are
per-direction (an edge is sampled toward its dst) and the two directions of
one undirected edge carry different weights.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from repro_torch.graph.csr import CSRGraph, build_csr
from repro_torch.core.presample import PresampleWeights

#: ``partition_graph``'s methods (the module docstring describes each)
PARTITION_METHODS = ("gsplit", "node", "edge", "rand", "telemetry")


@dataclass
class ReplicationSet:
    """Hot vertices whose input features are resident on *every* split.

    The communication-avoiding axis complementary to min-cut partitioning
    (CAGNET): a replicated vertex answers every bottom-layer aggregate that
    reads it locally, so its rows never ride the all-to-all. ``slot_of`` maps
    a global vertex id to its row in the static ``(R, F)`` replicated feature
    block (-1 = not replicated); the split planner reroutes edges whose src
    has a slot into the replicated region of the mixed buffer.
    """

    vertices: np.ndarray  # (R,) int64 global ids, sorted ascending
    slot_of: np.ndarray  # (num_nodes,) int32 row in the rep block, -1 = none
    budget_rows: int  # rows the memory budget allowed (R <= budget_rows)

    @property
    def num_replicated(self) -> int:
        return int(self.vertices.shape[0])


@dataclass
class Partition:
    """A global partitioning function f_G: V -> device."""

    assignment: np.ndarray  # (num_nodes,) int32 in [0, num_parts)
    num_parts: int
    method: str
    # optional hot-vertex replication set (select_replication); None = off
    replication: ReplicationSet | None = None

    def loads(self, vertex_weight: np.ndarray) -> np.ndarray:
        return np.bincount(
            self.assignment, weights=vertex_weight, minlength=self.num_parts
        )

    def cut_weight(self, graph: CSRGraph, edge_weight: np.ndarray) -> float:
        """Weighted cut under the module's directed-CSR-sum convention.

        Sums ``edge_weight`` over every directed CSR edge crossing the
        partition — on a symmetrized graph each undirected edge contributes
        both of its (generally unequal) per-direction weights. This is the
        exact objective ``_refine`` descends and ``partition_graph`` uses to
        pick the best multi-start, so the three never disagree.
        """
        dst = np.repeat(np.arange(graph.num_nodes), graph.degrees())
        src = graph.indices
        cross = self.assignment[src] != self.assignment[dst]
        return float(edge_weight[cross].sum())


def _edge_list(graph: CSRGraph) -> tuple[np.ndarray, np.ndarray]:
    dst = np.repeat(
        np.arange(graph.num_nodes, dtype=np.int64), graph.degrees()
    )
    return graph.indices.astype(np.int64), dst


def _ldg_stream(
    graph: CSRGraph,
    w_v: np.ndarray,
    w_e: np.ndarray,
    num_parts: int,
    eps: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """LDG streaming placement in degree-descending order."""
    n = graph.num_nodes
    assign = np.full(n, -1, dtype=np.int32)
    capacity = (1.0 + eps) * w_v.sum() / num_parts
    capacity = max(capacity, w_v.max() * 1.001 if n else 1.0)
    loads = np.zeros(num_parts, dtype=np.float64)

    order = np.argsort(-(graph.degrees() + rng.random(n)))  # jittered tie-break
    indptr, indices = graph.indptr, graph.indices
    for v in order:
        nbrs = indices[indptr[v] : indptr[v + 1]]
        wts = w_e[indptr[v] : indptr[v + 1]]
        placed = assign[nbrs]
        mask = placed >= 0
        conn = np.zeros(num_parts, dtype=np.float64)
        if mask.any():
            np.add.at(conn, placed[mask], wts[mask])
        score = (conn + 1e-12) * np.maximum(0.0, 1.0 - loads / capacity)
        full = loads + w_v[v] > capacity
        score[full] = -np.inf
        if np.all(np.isneginf(score)):  # everything "full": least loaded
            p = int(np.argmin(loads))
        else:
            p = int(np.argmax(score))
        assign[v] = p
        loads[p] += w_v[v]
    return assign


def _refine(
    graph: CSRGraph,
    assign: np.ndarray,
    w_v: np.ndarray,
    w_e: np.ndarray,
    num_parts: int,
    eps: float,
    max_passes: int = 8,
    max_moves_per_pass: int = 4096,
) -> np.ndarray:
    """Vectorized greedy boundary refinement under the (1+eps) balance bound.

    Descends the module's directed-CSR-sum cut exactly: moving ``v`` from
    ``a`` to ``q`` changes the cut by ``conn[v, a] - conn[v, q]`` where
    ``conn[v, p]`` sums the weight of *both directions* of every edge
    between ``v`` and partition ``p`` — the same double-direction counting
    as ``Partition.cut_weight``, so each applied move's gain is the true
    cut delta (no halving).

    Within a pass, gains are computed once against the pass-entry
    assignment, so a move is only applied if none of the vertex's neighbors
    moved earlier in the same pass (a non-neighbor's move cannot change the
    gain). This locking makes every applied move's precomputed gain exact,
    which gives the invariant the property suite pins: refinement never
    increases the weighted cut.
    """
    n = graph.num_nodes
    src, dst = _edge_list(graph)
    # out-neighbor adjacency (in-neighbors are contiguous in the CSR itself)
    # for the move locking below — built once per call
    out_order = np.argsort(src, kind="stable")
    out_indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(src, minlength=n))]
    )
    out_nbrs = dst[out_order]
    cap = (1.0 + eps) * w_v.sum() / num_parts
    assign = assign.copy()
    for _ in range(max_passes):
        # connection weight of every vertex to every partition (both edge
        # directions — the directed-sum cut convention)
        conn = np.zeros((n, num_parts), dtype=np.float64)
        np.add.at(conn, (dst, assign[src]), w_e)
        np.add.at(conn, (src, assign[dst]), w_e)
        cur = conn[np.arange(n), assign]
        best_p = np.argmax(conn, axis=1).astype(np.int32)
        gain = conn[np.arange(n), best_p] - cur
        cand = np.flatnonzero((gain > 1e-12) & (best_p != assign))
        if cand.size == 0:
            break
        cand = cand[np.argsort(-gain[cand])][:max_moves_per_pass]
        loads = np.bincount(assign, weights=w_v, minlength=num_parts)
        dirty = np.zeros(n, dtype=bool)  # vertices with a moved neighbor
        moved = 0
        for v in cand:
            if dirty[v]:
                continue  # a neighbor moved: the precomputed gain is stale
            q = best_p[v]
            if loads[q] + w_v[v] <= cap:
                loads[assign[v]] -= w_v[v]
                loads[q] += w_v[v]
                assign[v] = q
                moved += 1
                dirty[graph.indices[graph.indptr[v] : graph.indptr[v + 1]]] = True
                dirty[out_nbrs[out_indptr[v] : out_indptr[v + 1]]] = True
        if moved == 0:
            break
    return assign


# --------------------------------------------------------------------------- #
# Multilevel scheme (the METIS stand-in): heavy-edge matching coarsening,
# LDG at the coarsest level, KL/FM refinement at every level on uncoarsening.
# --------------------------------------------------------------------------- #
def _heavy_edge_matching(
    graph: CSRGraph, w_e: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """Mutual heaviest-neighbor matching. Returns cluster id per node."""
    n = graph.num_nodes
    src, dst = _edge_list(graph)
    # each node picks its heaviest incident edge's neighbor (last write on
    # ascending-weight order wins; jitter breaks ties randomly)
    order = np.lexsort((rng.random(len(w_e)), w_e))  # ascending
    pick = np.full(n, -1, dtype=np.int64)
    pick[dst[order]] = src[order]
    # mutual matches only (v and pick[v] chose each other)
    cand = np.arange(n)
    has = pick >= 0
    safe_pick = np.where(has, pick, 0)
    mutual = has & (pick[safe_pick] == cand) & (cand < safe_pick)
    cluster = np.full(n, -1, dtype=np.int64)
    matched_lo = cand[mutual]
    cluster[matched_lo] = np.arange(matched_lo.shape[0])
    cluster[pick[matched_lo]] = cluster[matched_lo]
    unmatched = cluster < 0
    cluster[unmatched] = matched_lo.shape[0] + np.arange(int(unmatched.sum()))
    return cluster


def _contract(
    graph: CSRGraph, cluster: np.ndarray, w_v: np.ndarray, w_e: np.ndarray
):
    """Contract matched clusters into a coarser weighted graph."""
    n2 = int(cluster.max()) + 1
    src, dst = _edge_list(graph)
    cs, cd = cluster[src], cluster[dst]
    keep = cs != cd
    cs, cd, we = cs[keep], cd[keep], w_e[keep]
    key = cs * n2 + cd
    uniq, inv = np.unique(key, return_inverse=True)
    we2 = np.bincount(inv, weights=we)
    s2 = (uniq // n2).astype(np.int64)
    d2 = (uniq % n2).astype(np.int64)
    g2 = build_csr(s2, d2, n2)
    # build_csr reorders edges by (dst, stable src order); re-derive weights
    order = np.argsort(d2, kind="stable")
    we2 = we2[order]
    wv2 = np.bincount(cluster, weights=w_v, minlength=n2)
    return g2, wv2, we2


def _multilevel(
    graph: CSRGraph,
    w_v: np.ndarray,
    w_e: np.ndarray,
    num_parts: int,
    eps: float,
    rng: np.random.Generator,
    refine_passes: int,
) -> np.ndarray:
    levels = []  # (cluster maps, finest -> coarsest)
    g, wv, we = graph, w_v, w_e
    while g.num_nodes > max(256, 32 * num_parts) and len(levels) < 20:
        cluster = _heavy_edge_matching(g, we, rng)
        if cluster.max() + 1 >= g.num_nodes * 0.95:  # matching stalled
            break
        g2, wv2, we2 = _contract(g, cluster, wv, we)
        levels.append((cluster, g, wv, we))
        g, wv, we = g2, wv2, we2

    assign = _ldg_stream(g, wv, we, num_parts, eps, rng)
    assign = _refine(g, assign, wv, we, num_parts, eps, max_passes=refine_passes * 2)

    for cluster, g_fine, wv_fine, we_fine in reversed(levels):
        assign = assign[cluster]  # project to the finer level
        assign = _refine(
            g_fine, assign, wv_fine, we_fine, num_parts, eps,
            max_passes=refine_passes,
        )
    return assign


def partition_graph(
    graph: CSRGraph,
    num_parts: int,
    method: str = "gsplit",
    weights: PresampleWeights | None = None,
    train_ids: np.ndarray | None = None,
    eps: float = 0.05,
    seed: int = 0,
    refine_passes: int = 8,
    n_starts: int = 4,
    replication_budget: float = 0.0,
) -> Partition:
    """Compute the global partitioning function f_G (Eq. 2 heuristic).

    ``replication_budget`` > 0 additionally selects a hot-vertex replication
    set (``select_replication``) sized to that fraction of the graph's
    feature memory and attaches it to the returned ``Partition``.
    """
    rng = np.random.default_rng(seed)
    n = graph.num_nodes

    if method == "rand":
        part = Partition(
            assignment=rng.integers(0, num_parts, size=n).astype(np.int32),
            num_parts=num_parts,
            method=method,
        )
        if replication_budget > 0:
            part.replication = select_replication(
                graph, num_parts, part.assignment, weights,
                replication_budget,
            )
        return part

    if method in ("gsplit", "node", "telemetry"):
        assert weights is not None, f"{method} partitioning needs presample weights"
        # Vertex load = expected appearances (k_v) + expected sampled in-edge
        # work: when v lands in a split, its GPU samples/aggregates its
        # in-edges, so the per-split computation is the sum of both terms
        # (paper §5: weights represent the computational cost incurred
        # during split-parallel sampling and training).
        dst = np.repeat(
            np.arange(graph.num_nodes, dtype=np.int64), graph.degrees()
        )
        in_load = np.bincount(
            dst, weights=weights.edge_weight, minlength=graph.num_nodes
        )
        w_v = weights.vertex_weight + in_load + 1e-9
        if method in ("gsplit", "telemetry"):
            # "telemetry" is the same objective with empirical (recorded)
            # counts in place of the presample estimates — the caller builds
            # the weights from an EdgeTelemetry accumulator
            w_e = weights.edge_weight + 1e-9
        else:
            w_e = np.ones(graph.num_edges, dtype=np.float64)
    elif method == "edge":
        # balance edges + target vertices, uniform edge weights (DistDGL-style)
        deg = graph.degrees().astype(np.float64)
        w_v = deg + 1.0
        if train_ids is not None and len(train_ids):
            bump = np.zeros(n)
            bump[train_ids] = max(1.0, deg.mean())
            w_v = w_v + bump
        w_e = np.ones(graph.num_edges, dtype=np.float64)
    else:
        raise ValueError(f"unknown partition method {method!r}")

    # multi-start (METIS-style): keep the assignment with the best Eq. 2
    # objective (weighted cut subject to the balance constraint)
    src, dst = _edge_list(graph)
    best, best_cut = None, np.inf
    for s in range(max(1, n_starts)):
        a = _multilevel(
            graph, w_v, w_e, num_parts, eps,
            np.random.default_rng(seed + 101 * s), refine_passes,
        )
        # the directed-CSR-sum cut — the same objective cut_weight reports
        cut = float(w_e[a[src] != a[dst]].sum())
        if cut < best_cut:
            best, best_cut = a, cut
    part = Partition(assignment=best, num_parts=num_parts, method=method)
    if replication_budget > 0:
        part.replication = select_replication(
            graph, num_parts, part.assignment, weights, replication_budget
        )
    return part


# --------------------------------------------------------------------------- #
# Hot-vertex replication (the CAGNET communication-avoiding axis) and the
# telemetry feedback loop that closes the paper's presample approximation.
# --------------------------------------------------------------------------- #
def select_replication(
    graph: CSRGraph,
    num_parts: int,
    assignment: np.ndarray,
    weights: PresampleWeights | None = None,
    replication_budget: float = 0.05,
) -> ReplicationSet | None:
    """Pick the top-k hot vertices to replicate on every split.

    Score = expected number of *distinct remote splits* that need vertex
    ``v``'s input row per mini-batch:

        score(v) = sum over parts p != f_G(v) of
                   1 - prod over edges e = (v -> d), f_G(d) = p of (1 - p_e)

    with ``p_e = min(k_e, 1)`` from the presample edge weights (uniform
    probabilities when ``weights`` is None). This targets the quantity
    replication actually removes — send-list *rows* are deduplicated per
    (owner, needer, vertex), so a hub needed by a split a thousand times
    still only costs one row; scoring raw edge appearances over-ranks such
    hubs and under-delivers wire savings.

    The budget is a fraction of the graph's feature memory: each device
    spends ``replication_budget * num_nodes * F`` extra bytes on the static
    replicated block, i.e. ``budget_rows = floor(budget * num_nodes)`` rows.
    Only vertices with positive score are selected, so the returned set can
    be smaller than the budget; it is never larger. Returns None when the
    budget or the selection is empty.
    """
    n = graph.num_nodes
    budget_rows = int(replication_budget * n)
    if budget_rows <= 0:
        return None
    src = graph.indices.astype(np.int64)
    dst = np.repeat(np.arange(n, dtype=np.int64), graph.degrees())
    if weights is not None:
        p_e = np.minimum(weights.edge_weight, 1.0)
    else:
        p_e = np.ones(graph.num_edges, dtype=np.float64)
    # log(1 - p_e), clamped so deterministically-sampled edges (p_e = 1)
    # contribute certainty without -inf
    log1m = np.log1p(-np.minimum(p_e, 1.0 - 1e-9))
    score = np.zeros(n, dtype=np.float64)
    for p in range(num_parts):
        to_p = assignment[dst] == p
        acc = np.zeros(n, dtype=np.float64)
        np.add.at(acc, src[to_p], log1m[to_p])
        prob = 1.0 - np.exp(acc)  # P(split p samples any edge out of v)
        prob[assignment == p] = 0.0  # local to p: never on the wire
        score += prob
    hot = np.argsort(-score, kind="stable")[:budget_rows]
    hot = hot[score[hot] > 0.0]
    if hot.size == 0:
        return None
    vertices = np.sort(hot).astype(np.int64)
    slot_of = np.full(n, -1, dtype=np.int32)
    slot_of[vertices] = np.arange(vertices.shape[0], dtype=np.int32)
    return ReplicationSet(
        vertices=vertices, slot_of=slot_of, budget_rows=budget_rows
    )


class EdgeTelemetry:
    """Thread-safe accumulator of per-batch vertex/edge appearance counts.

    Records the same ``k_v``/``k_e`` statistics as the offline presample
    stage, but from the mini-batches the trainer *actually* runs — the
    empirical feedback the ``telemetry`` partition method and
    ``refine_partition`` consume. ``record`` is called from plan-producer
    threads (the pipelined sources are multi-worker), so two locks split the
    work: the buffer lock only ever guards O(batch) list appends and pointer
    swaps, while the O(V+E) concatenate+bincount runs outside it — one
    producer flushing must not stall its siblings mid-epoch. The dense
    accumulators get their own lock; merges are commutative adds, so flush
    order across threads cannot change the totals.
    """

    _FLUSH_EVERY = 64  # buffered batches between dense bincount flushes

    def __init__(self, num_nodes: int, num_edges: int):
        self._lock = threading.Lock()  # buffers + num_batches
        self._dense_lock = threading.Lock()  # _k_v/_k_e merges
        self._vbuf: list[np.ndarray] = []
        self._ebuf: list[np.ndarray] = []
        self._k_v = np.zeros(num_nodes, dtype=np.int64)
        self._k_e = np.zeros(num_edges, dtype=np.int64)
        self.num_batches = 0

    def record(self, sample) -> None:
        """Accumulate one ``MiniBatchSample``'s appearance counts."""
        with self._lock:
            self._vbuf.extend(sample.frontiers[:-1])
            self._ebuf.extend(layer.edge_id for layer in sample.layers)
            self.num_batches += 1
            if self.num_batches % self._FLUSH_EVERY != 0:
                return
            vbuf, self._vbuf = self._vbuf, []
            ebuf, self._ebuf = self._ebuf, []
        self._merge(vbuf, ebuf)

    def _merge(self, vbuf: list[np.ndarray], ebuf: list[np.ndarray]) -> None:
        """Bincount outside any lock; only the dense adds are serialized."""
        k_v = k_e = None
        if vbuf:
            verts = np.concatenate(vbuf)
            k_v = np.bincount(verts, minlength=self._k_v.shape[0])
        if ebuf:
            eids = np.concatenate(ebuf)
            eids = eids[eids >= 0]  # self-loop sentinels are not CSR edges
            k_e = np.bincount(eids, minlength=self._k_e.shape[0])
        with self._dense_lock:
            if k_v is not None:
                self._k_v += k_v
            if k_e is not None:
                self._k_e += k_e

    def counters(self) -> dict:
        """Snapshot the dense counters (pending buffers flushed first).

        The checkpoint cursor carries these so a resumed run's telemetry —
        and therefore any later ``refine_partition`` feedback — matches an
        uninterrupted run's. Arrays are copies; safe to hand to ``np.savez``.
        """
        with self._lock:
            vbuf, self._vbuf = self._vbuf, []
            ebuf, self._ebuf = self._ebuf, []
            num_batches = self.num_batches
        self._merge(vbuf, ebuf)
        with self._dense_lock:
            return {
                "k_v": self._k_v.copy(),
                "k_e": self._k_e.copy(),
                "num_batches": num_batches,
            }

    def load_counters(self, counters: dict) -> None:
        """Restore a ``counters()`` snapshot (checkpoint resume)."""
        with self._lock:
            self._vbuf = []
            self._ebuf = []
            self.num_batches = int(counters["num_batches"])
        with self._dense_lock:
            self._k_v[:] = counters["k_v"]
            self._k_e[:] = counters["k_e"]

    def as_weights(self) -> PresampleWeights:
        """Empirical weights: per-batch appearance rates.

        Only the *relative* weights matter to the partitioner (balance and
        cut are both scale-free up to the tiny tie-break offsets), so counts
        are normalized per recorded batch. Callers invoke this between
        epochs (producers quiescent); a racing ``record`` would merge its
        counts either before or after the snapshot, never partially.
        """
        with self._lock:
            vbuf, self._vbuf = self._vbuf, []
            ebuf, self._ebuf = self._ebuf, []
            num_batches = self.num_batches
        self._merge(vbuf, ebuf)
        with self._dense_lock:
            denom = float(max(num_batches, 1))
            return PresampleWeights(
                vertex_weight=self._k_v / denom,
                edge_weight=self._k_e / denom,
                num_epochs=max(num_batches, 1),
            )


def refine_partition(
    graph: CSRGraph,
    part: Partition,
    weights: PresampleWeights,
    eps: float = 0.05,
    refine_passes: int = 8,
    replication_budget: float = 0.0,
) -> Partition:
    """Refine an existing partition against (typically empirical) weights.

    The telemetry feedback pass: re-runs the boundary refinement from the
    current assignment with the gsplit objective under ``weights`` — usually
    ``EdgeTelemetry.as_weights()`` recorded during training. Because
    ``_refine`` applies only exact-positive-gain moves (move locking, see
    its docstring), the weighted cut under ``weights`` never increases, even
    when the starting assignment came from different (presample) weights.
    A fresh replication set is selected against the refined assignment when
    a budget is given.
    """
    dst = np.repeat(np.arange(graph.num_nodes, dtype=np.int64), graph.degrees())
    in_load = np.bincount(
        dst, weights=weights.edge_weight, minlength=graph.num_nodes
    )
    w_v = weights.vertex_weight + in_load + 1e-9
    w_e = weights.edge_weight + 1e-9
    assign = _refine(
        graph, part.assignment, w_v, w_e, part.num_parts, eps,
        max_passes=refine_passes,
    )
    refined = Partition(
        assignment=assign, num_parts=part.num_parts, method="telemetry"
    )
    if replication_budget > 0:
        refined.replication = select_replication(
            graph, part.num_parts, assign, weights, replication_budget
        )
    return refined
