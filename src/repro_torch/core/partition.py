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

The weights are GSplit's: pre-sampled vertex AND edge weights
(``method="gsplit"``, with probabilistic guarantees).

A numpy copy of ``repro.core.partition`` restricted to ``partition_graph``
with ``method="gsplit"``; the ablation's other partitioners (node, edge,
rand), hot-vertex replication and the telemetry feedback loop come with
later slices of the port.

Cut convention (used consistently by the multi-start ``best_cut``
selection and ``_refine``): the cut is the sum of
``w_E(e)`` over all *directed CSR edges* whose endpoints live on different
partitions. Symmetrized graphs therefore count each undirected edge once per
direction — deliberately, because the presampled ``k_e`` weights are
per-direction (an edge is sampled toward its dst) and the two directions of
one undirected edge carry different weights.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.graph.csr import CSRGraph, build_csr
from repro_torch.core.presample import PresampleWeights


@dataclass
class Partition:
    """A global partitioning function f_G: V -> device."""

    assignment: np.ndarray  # (num_nodes,) int32 in [0, num_parts)
    num_parts: int
    method: str


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
    as the module's cut convention, so each applied move's gain is the true
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
    eps: float = 0.05,
    seed: int = 0,
    refine_passes: int = 8,
    n_starts: int = 4,
) -> Partition:
    """Compute the global partitioning function f_G (Eq. 2 heuristic)."""
    if method != "gsplit":
        raise ValueError(
            f"partition method {method!r} is not ported yet (the node/edge/"
            "rand ablation arms: a later slice of the port)"
        )
    if weights is None:
        raise ValueError("gsplit partitioning needs presample weights")
    # Vertex load = expected appearances (k_v) + expected sampled in-edge
    # work: when v lands in a split, its GPU samples/aggregates its
    # in-edges, so the per-split computation is the sum of both terms
    # (paper §5: weights represent the computational cost incurred
    # during split-parallel sampling and training).
    src, dst = _edge_list(graph)
    in_load = np.bincount(
        dst, weights=weights.edge_weight, minlength=graph.num_nodes
    )
    w_v = weights.vertex_weight + in_load + 1e-9
    w_e = weights.edge_weight + 1e-9

    # multi-start (METIS-style): keep the assignment with the best Eq. 2
    # objective (weighted cut subject to the balance constraint)
    best, best_cut = None, np.inf
    for s in range(max(1, n_starts)):
        a = _multilevel(
            graph, w_v, w_e, num_parts, eps,
            np.random.default_rng(seed + 101 * s), refine_passes,
        )
        # the directed-CSR-sum cut — the objective _refine descends
        cut = float(w_e[a[src] != a[dst]].sum())
        if cut < best_cut:
            best, best_cut = a, cut
    return Partition(assignment=best, num_parts=num_parts, method=method)
