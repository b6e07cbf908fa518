"""Synthetic graph datasets.

CPU-scale stand-ins for the paper's evaluation graphs (Table 2):

  Orkut       3.1M nodes / 120M edges / feat 512   -> ``orkut-s``
  Papers100M  111M nodes / 1.6B edges / feat 128   -> ``papers-s``
  Friendster  65M  nodes / 1.9B edges / feat 128   -> ``friendster-s``

We generate RMAT (power-law, community-structured) graphs whose *shape
statistics* (avg degree, skew) mirror the originals at a node count that fits
this container. All paper-claim validations (redundancy ratios, partitioner
quality orderings, load balance) are statements about these statistics, not
about absolute scale.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.graph.csr import CSRGraph, build_csr, to_undirected


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_nodes: int
    avg_degree: float
    feat_dim: int
    num_classes: int = 16
    train_fraction: float = 0.1
    generator: str = "rmat"  # rmat | power_law
    rmat_abcd: tuple[float, float, float, float] = (0.57, 0.19, 0.19, 0.05)
    # Community structure: fraction of edges constrained to their source's
    # block (real social/citation graphs are strongly clustered — RMAT alone
    # at small node counts degenerates to an expander with no good cuts,
    # unlike Orkut/Papers100M/Friendster).
    locality: float = 0.8
    num_communities: int = 64
    seed: int = 0


# Scaled-down mirrors of the paper's Table 2 graphs.
SYNTHETIC_DATASETS: dict[str, DatasetSpec] = {
    # Orkut: dense social graph (avg deg ~77 in the paper; we keep the density)
    "orkut-s": DatasetSpec("orkut-s", num_nodes=8192, avg_degree=64.0, feat_dim=512),
    # Papers100M: sparse citation graph (avg deg ~14), larger node count
    "papers-s": DatasetSpec("papers-s", num_nodes=32768, avg_degree=14.0, feat_dim=128),
    # Friendster: sparse social graph (avg deg ~29)
    "friendster-s": DatasetSpec(
        "friendster-s", num_nodes=16384, avg_degree=28.0, feat_dim=128
    ),
    # tiny debug graph
    "tiny": DatasetSpec("tiny", num_nodes=256, avg_degree=8.0, feat_dim=16,
                        num_classes=4, train_fraction=0.25),
}


def rmat_edges(
    num_nodes: int,
    num_edges: int,
    abcd: tuple[float, float, float, float],
    rng: np.random.Generator,
) -> tuple[np.ndarray, np.ndarray]:
    """Recursive-matrix (RMAT) edge generator — power-law with communities."""
    scale = int(np.ceil(np.log2(max(num_nodes, 2))))
    a, b, c, d = abcd
    # per-bit quadrant choice, vectorized across all edges
    src = np.zeros(num_edges, dtype=np.int64)
    dst = np.zeros(num_edges, dtype=np.int64)
    p_right = (b + d) / (a + b + c + d)  # P(dst bit = 1)
    for bit in range(scale):
        r1 = rng.random(num_edges)
        r2 = rng.random(num_edges)
        # correlated quadrant draw: first choose dst bit, then src bit given dst
        dst_bit = (r1 < p_right).astype(np.int64)
        p_src1_given = np.where(dst_bit == 1, d / (b + d), c / (a + c))
        src_bit = (r2 < p_src1_given).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    src %= num_nodes
    dst %= num_nodes
    return src, dst


def power_law_edges(
    num_nodes: int, num_edges: int, exponent: float, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray]:
    """Chung-Lu style: endpoints drawn prop. to a power-law weight sequence."""
    w = (np.arange(1, num_nodes + 1, dtype=np.float64)) ** (-1.0 / (exponent - 1.0))
    p = w / w.sum()
    src = rng.choice(num_nodes, size=num_edges, p=p)
    dst = rng.choice(num_nodes, size=num_edges, p=p)
    return src.astype(np.int64), dst.astype(np.int64)


@dataclass
class GraphDataset:
    spec: DatasetSpec
    graph: CSRGraph
    features: np.ndarray  # (num_nodes, feat_dim) float32
    labels: np.ndarray  # (num_nodes,) int32
    train_ids: np.ndarray  # (num_train,) int64, shuffled
    extras: dict = field(default_factory=dict)


def make_dataset(spec_or_name: DatasetSpec | str, seed: int | None = None) -> GraphDataset:
    spec = (
        SYNTHETIC_DATASETS[spec_or_name]
        if isinstance(spec_or_name, str)
        else spec_or_name
    )
    rng = np.random.default_rng(spec.seed if seed is None else seed)
    num_edges = int(spec.num_nodes * spec.avg_degree / 2)
    if spec.generator == "rmat":
        src, dst = rmat_edges(spec.num_nodes, num_edges, spec.rmat_abcd, rng)
    elif spec.generator == "power_law":
        src, dst = power_law_edges(spec.num_nodes, num_edges, 2.5, rng)
    else:
        raise ValueError(f"unknown generator {spec.generator!r}")
    if spec.locality > 0 and spec.num_communities > 1:
        # pull a fraction of edges inside their source's community block
        block = max(1, spec.num_nodes // spec.num_communities)
        local = rng.random(src.shape[0]) < spec.locality
        dst = np.where(local, (src // block) * block + dst % block, dst)
        dst = np.minimum(dst, spec.num_nodes - 1)
    src, dst = to_undirected(src, dst)
    graph = build_csr(src, dst, spec.num_nodes)
    graph.validate()

    # Features correlated with the label so a few training steps measurably
    # reduce loss (used by e2e example assertions).
    labels = rng.integers(0, spec.num_classes, size=spec.num_nodes).astype(np.int32)
    centers = rng.normal(0, 1.0, size=(spec.num_classes, spec.feat_dim))
    features = (
        centers[labels] + rng.normal(0, 2.0, size=(spec.num_nodes, spec.feat_dim))
    ).astype(np.float32)

    num_train = max(1, int(spec.num_nodes * spec.train_fraction))
    train_ids = rng.permutation(spec.num_nodes)[:num_train].astype(np.int64)
    return GraphDataset(
        spec=spec, graph=graph, features=features, labels=labels, train_ids=train_ids
    )
