"""Device CSR shard format — a numpy copy of ``repro/sampler/shard.py``
(docs/SAMPLER.md §2), with ``shards_to_device`` for torch.

The global CSR (``graph.csr``) is host-resident; the cooperative sampler
needs each split to expand *only the vertices it owns* on device. This module
reshapes the CSR into padded per-partition blocks under the global
partitioning function ``f_G`` (``core.partition``):

  * ``indptr  (P, V_cap + 1)`` -- per-partition row offsets over *local rows*
    (partition ``p``'s vertices in ascending global id), edge-padded so rows
    beyond ``num_local[p]`` read as empty;
  * ``indices (P, E_cap)``     -- global neighbor ids per local row;
  * ``edge_id (P, E_cap)``     -- global CSR edge ids (feeds presample
    accounting and plan ``edge_id`` fields);
  * ``owner (V,)`` / ``local_row (V,)`` -- the global -> (partition, local
    row) map, replicated on every device (two int32 vectors — the only
    O(V) state the sampler keeps per device).

``V_cap``/``E_cap`` are power-of-two padded maxima across partitions so the
blocks stack into one static-shape array per field — the shard is built once
per run and stays device-resident (like the feature cache's (P, C, F)
block, DESIGN.md §2).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels.gather_segsum.layout import pow2_at_least


@dataclass(frozen=True)
class GraphShards:
    """Padded per-partition CSR blocks + the global ownership map."""

    indptr: np.ndarray  # (P, V_cap + 1) int32, edge-padded
    indices: np.ndarray  # (P, E_cap) int32 global neighbor ids
    edge_id: np.ndarray  # (P, E_cap) int32 global CSR edge ids
    owner: np.ndarray  # (V,) int32 owning partition of each vertex
    local_row: np.ndarray  # (V,) int32 row within the owner's block
    num_local: np.ndarray  # (P,) int32 true local vertex counts

    @property
    def num_parts(self) -> int:
        return int(self.indptr.shape[0])

    @property
    def num_nodes(self) -> int:
        return int(self.owner.shape[0])

    @property
    def v_cap(self) -> int:
        return int(self.indptr.shape[1] - 1)

    @property
    def e_cap(self) -> int:
        return int(self.indices.shape[1])

    def validate(self) -> None:
        P, V = self.num_parts, self.num_nodes
        assert self.owner.min() >= 0 and self.owner.max() < P
        counts = np.bincount(self.owner, minlength=P)
        assert np.array_equal(counts, self.num_local)
        assert counts.max(initial=0) <= self.v_cap
        # local_row is a bijection within each partition
        for p in range(P):
            rows = self.local_row[self.owner == p]
            assert np.array_equal(np.sort(rows), np.arange(counts[p]))
        assert np.all(np.diff(self.indptr, axis=1) >= 0)


def build_shards(
    graph: CSRGraph, assignment: np.ndarray, num_parts: int
) -> GraphShards:
    """Shard the CSR by ``assignment`` (one numpy pass, run at trainer init).

    Local rows are assigned in ascending global-id order per partition, so a
    device's frontier block (sorted unique global ids) maps to monotone local
    rows — the property the engine's sort-based dedup relies on.
    """
    V = graph.num_nodes
    assignment = np.asarray(assignment, dtype=np.int32)
    assert assignment.shape == (V,)
    # the ownership-routing sort packs (owner, vertex) into one int32 key,
    # and the shard's edge_id block stores global edge ids as int32
    assert num_parts * V < 2**31, "sampler shard: P * V must fit in int32"
    assert graph.num_edges < 2**31, "sampler shard: edge ids must fit int32"

    deg = graph.degrees().astype(np.int64)
    counts = np.bincount(assignment, minlength=num_parts).astype(np.int64)
    local_row = np.empty(V, dtype=np.int32)
    edge_tot = np.zeros(num_parts, dtype=np.int64)
    order = np.argsort(assignment, kind="stable")  # ascending v within p
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    local_row[order] = (np.arange(V) - np.repeat(starts, counts)).astype(
        np.int32
    )
    np.add.at(edge_tot, assignment, deg)

    V_cap = pow2_at_least(max(int(counts.max(initial=0)), 1), floor=8)
    E_cap = pow2_at_least(max(int(edge_tot.max(initial=0)), 1), floor=8)
    indptr = np.zeros((num_parts, V_cap + 1), dtype=np.int32)
    indices = np.zeros((num_parts, E_cap), dtype=np.int32)
    edge_id = np.zeros((num_parts, E_cap), dtype=np.int32)
    for p in range(num_parts):
        verts = order[starts[p] : starts[p] + counts[p]]
        d = deg[verts]
        off = np.concatenate([[0], np.cumsum(d)])
        indptr[p, 1 : counts[p] + 1] = off[1:]
        indptr[p, counts[p] + 1 :] = off[-1]  # edge-pad: empty tail rows
        if off[-1]:
            # gather each local row's global CSR slice, vectorized
            eids = (
                np.repeat(graph.indptr[verts], d)
                + np.arange(int(off[-1]), dtype=np.int64)
                - np.repeat(off[:-1], d)
            )
            indices[p, : off[-1]] = graph.indices[eids]
            edge_id[p, : off[-1]] = eids.astype(np.int32)

    return GraphShards(
        indptr=indptr,
        indices=indices,
        edge_id=edge_id,
        owner=assignment.copy(),
        local_row=local_row,
        num_local=counts.astype(np.int32),
    )


def shards_to_device(shards: GraphShards, device) -> dict:
    """Shard fields as int32 tensors on ``device`` (uploaded once per run)."""
    return {
        name: torch.as_tensor(getattr(shards, name), device=device)
        for name in (
            "indptr", "indices", "edge_id", "owner", "local_row", "num_local"
        )
    }
