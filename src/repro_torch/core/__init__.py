"""Split parallelism core: presample -> partition -> online split -> shuffle."""
from repro_torch.core.partition import (
    EdgeTelemetry,
    Partition,
    ReplicationSet,
    partition_graph,
    refine_partition,
    select_replication,
)
from repro_torch.core.presample import PresampleWeights, presample
from repro_torch.core.shuffle import (
    SimComm,
    SpmdComm,
    replica_grad_mean,
    sim_alltoall,
    sim_append_replicated,
    sim_shuffle,
    spmd_alltoall,
    spmd_append_replicated,
    spmd_serve_features,
    spmd_shuffle,
    wire_cast,
)
from repro_torch.core.splitting import (
    LayerPlan,
    SplitPlan,
    build_dp_plan,
    build_split_plan,
    repad_plan,
)

__all__ = [
    "PresampleWeights",
    "presample",
    "Partition",
    "ReplicationSet",
    "EdgeTelemetry",
    "partition_graph",
    "refine_partition",
    "select_replication",
    "SplitPlan",
    "LayerPlan",
    "build_split_plan",
    "build_dp_plan",
    "repad_plan",
    "sim_alltoall",
    "sim_append_replicated",
    "sim_shuffle",
    "spmd_alltoall",
    "spmd_append_replicated",
    "spmd_serve_features",
    "spmd_shuffle",
    "SimComm",
    "SpmdComm",
    "replica_grad_mean",
    "wire_cast",
]
