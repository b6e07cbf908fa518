"""GNN models (GraphSAGE, GCN, GAT) on the split-parallel path."""
from repro_torch.models.gnn.layers import (
    GNN,
    GNNSpec,
    gnn_forward,
    gnn_forward_cached,
    gnn_forward_spmd,
    gnn_layer_apply,
    params_from_jax,
)

__all__ = ["GNN", "GNNSpec", "gnn_forward", "gnn_forward_cached",
           "gnn_forward_spmd", "gnn_layer_apply", "params_from_jax"]
