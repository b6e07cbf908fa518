"""Split parallelism core: presample -> partition -> online split -> shuffle."""
from repro_torch.core.partition import Partition, partition_graph
from repro_torch.core.presample import PresampleWeights, presample
from repro_torch.core.shuffle import sim_alltoall, sim_shuffle, wire_cast
from repro_torch.core.splitting import (
    LayerPlan,
    SplitPlan,
    build_split_plan,
    repad_plan,
)

__all__ = [
    "PresampleWeights",
    "presample",
    "Partition",
    "partition_graph",
    "SplitPlan",
    "LayerPlan",
    "build_split_plan",
    "repad_plan",
    "sim_alltoall",
    "sim_shuffle",
    "wire_cast",
]
