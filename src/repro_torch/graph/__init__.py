"""Graph substrate: CSR storage, synthetic datasets, neighbor sampling."""
from repro_torch.graph.csr import CSRGraph, build_csr, to_undirected
from repro_torch.graph.datasets import (
    SYNTHETIC_DATASETS,
    DatasetSpec,
    GraphDataset,
    make_dataset,
)
from repro_torch.graph.sampling import (
    LayerSample,
    MiniBatchSample,
    NeighborSampler,
    sample_minibatch,
)

__all__ = [
    "CSRGraph",
    "build_csr",
    "to_undirected",
    "DatasetSpec",
    "GraphDataset",
    "SYNTHETIC_DATASETS",
    "make_dataset",
    "NeighborSampler",
    "LayerSample",
    "MiniBatchSample",
    "sample_minibatch",
]
