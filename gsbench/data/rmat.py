"""The benchmark's graph: an RMAT graph with community structure,
symmetrised, stored as an in-neighbourhood CSR, with a train split, all
drawn from the configuration's fixed ``graph_seed`` (the dataset a
deployment trains on, so that every run's seed meets the same sizes), and
labels and label-correlated features drawn from the run's seed.

A frozen copy of the generator the port ships (``graph/datasets.py``), so
that a change to the program cannot change the benchmark's inputs. The arrays
are plain numpy; the driver hands the same arrays to the program and to the
reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Graph:
    indptr: np.ndarray  # (N + 1,) int64: rows are in-neighbourhoods
    indices: np.ndarray  # (E,) int32 source of each in-edge
    features: np.ndarray  # (N, F) float32
    labels: np.ndarray  # (N,) int32
    train_ids: np.ndarray  # (T,) int64, in a seeded order

    @property
    def num_nodes(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])


def rmat_edges(num_nodes, num_edges, abcd, rng):
    """Recursive-matrix edges: per bit a destination bit, then a source bit
    given it."""
    scale = int(np.ceil(np.log2(max(num_nodes, 2))))
    a, b, c, d = abcd
    src = np.zeros(num_edges, dtype=np.int64)
    dst = np.zeros(num_edges, dtype=np.int64)
    p_right = (b + d) / (a + b + c + d)
    for _ in range(scale):
        r1 = rng.random(num_edges)
        r2 = rng.random(num_edges)
        dst_bit = (r1 < p_right).astype(np.int64)
        p_src1 = np.where(dst_bit == 1, d / (b + d), c / (a + c))
        src_bit = (r2 < p_src1).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    return src % num_nodes, dst % num_nodes


def _undirected(src, dst):
    """Both directions of every edge, without self loops or duplicates."""
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    keep = s != d
    s, d = s[keep], d[keep]
    n = int(max(s.max(initial=0), d.max(initial=0))) + 1
    _, first = np.unique(s * n + d, return_index=True)
    return s[first], d[first]


def _in_csr(src, dst, num_nodes):
    order = np.argsort(dst, kind="stable")
    counts = np.bincount(dst[order], minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, src[order].astype(np.int32)


def make_graph(graph_cfg: dict, seed: int) -> Graph:
    """The graph of a configuration: edges and train split from its
    ``graph_seed``, labels and features from ``seed``.

    Keys: ``graph_seed``, ``num_nodes``, ``avg_degree``, ``feat_dim``,
    ``num_classes``, ``train_fraction``, ``locality`` (the share of edges
    pulled inside their source's community block), ``num_communities`` and
    ``rmat_abcd``.
    """
    n = int(graph_cfg["num_nodes"])
    shape = np.random.default_rng(int(graph_cfg["graph_seed"]))
    num_edges = int(n * graph_cfg["avg_degree"] / 2)
    src, dst = rmat_edges(n, num_edges, tuple(graph_cfg["rmat_abcd"]), shape)
    communities = int(graph_cfg["num_communities"])
    if graph_cfg["locality"] > 0 and communities > 1:
        block = max(1, n // communities)
        local = shape.random(src.shape[0]) < graph_cfg["locality"]
        dst = np.where(local, (src // block) * block + dst % block, dst)
        dst = np.minimum(dst, n - 1)
    indptr, indices = _in_csr(*_undirected(src, dst), n)
    num_train = max(1, int(n * graph_cfg["train_fraction"]))
    train_ids = shape.permutation(n)[:num_train].astype(np.int64)
    rng = np.random.default_rng(seed)
    classes, width = int(graph_cfg["num_classes"]), int(graph_cfg["feat_dim"])
    labels = rng.integers(0, classes, size=n).astype(np.int32)
    centers = rng.standard_normal((classes, width), dtype=np.float32)
    features = rng.standard_normal((n, width), dtype=np.float32)
    features *= np.float32(2.0)
    features += centers[labels]
    return Graph(indptr, indices, features, labels, train_ids)
