"""CSR graph storage.

The graph substrate is host-resident (numpy): sampling and split-plan
construction are host-side pipeline stages (the paper runs them on GPU; on TPU
the idiomatic equivalent is a host pipeline feeding static-shape device
batches, see DESIGN.md §3). Device code only ever sees padded index arrays.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CSRGraph:
    """Compressed-sparse-row adjacency.

    ``indptr``  -- (num_nodes + 1,) int64 row offsets.
    ``indices`` -- (num_edges,) int32 neighbor ids per row.

    Rows are *incoming* neighborhoods: ``indices[indptr[v]:indptr[v+1]]`` are
    the message sources aggregated into ``v`` (GNN convention: we sample the
    in-neighborhood of each frontier vertex).
    """

    indptr: np.ndarray
    indices: np.ndarray

    @property
    def num_nodes(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def validate(self) -> None:
        assert self.indptr.ndim == 1 and self.indices.ndim == 1
        assert self.indptr[0] == 0 and self.indptr[-1] == self.num_edges
        assert np.all(np.diff(self.indptr) >= 0)
        if self.num_edges:
            assert self.indices.min() >= 0
            assert self.indices.max() < self.num_nodes

    def edge_id(self, dst: np.ndarray, slot: np.ndarray) -> np.ndarray:
        """Global edge id of the ``slot``-th in-edge of ``dst``."""
        return self.indptr[dst] + slot


def build_csr(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> CSRGraph:
    """Build an in-neighborhood CSR from a directed edge list src -> dst."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    assert src.shape == dst.shape
    order = np.argsort(dst, kind="stable")
    dst_sorted = dst[order]
    src_sorted = src[order]
    counts = np.bincount(dst_sorted, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr=indptr, indices=src_sorted.astype(np.int32))


def to_undirected(src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetrize an edge list (and drop self loops / duplicates)."""
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    keep = s != d
    s, d = s[keep], d[keep]
    # dedup via a packed key
    n = int(max(s.max(initial=0), d.max(initial=0))) + 1
    key = s.astype(np.int64) * n + d.astype(np.int64)
    _, uniq_idx = np.unique(key, return_index=True)
    return s[uniq_idx], d[uniq_idx]
