"""A cell shrunk to a size a CPU test can hold: the configuration's graph
and the traffic's batch cut, the widths kept unless ``narrow``, and the
check's limits for that size where they differ from the cell's."""
import contextlib

from gsbench import run


#: Limits at the shrunk size, set by the cell's rules from readings at this
#: size (14 seeds: the program's largest, and the control's or a fault's
#: smallest). On 16 targets a step GAT's later-step loss and its attention
#: leaves' change are rounding-dominated: the program reads up to 7.5e-4 and
#: 0.21, above the control's smallest (1.1e-4, 4.2e-3), so there the upper
#: readings are the faults' (``loss_altered`` 0.01, ``frozen`` 1).
SMALL_LIMITS = {"gat-papers256k-split": {"loss_gap": 3e-3, "change_gap": 0.5}}


def small_limits(workload: str, limits: dict) -> dict:
    return dict(limits, **SMALL_LIMITS.get(workload, {}))


def shrink(cfg: dict, traffic: dict, narrow: bool = False) -> tuple:
    cfg = dict(cfg, num_nodes=4096)
    if narrow:
        cfg.update(feat_dim=16, hidden_dim=32, num_classes=8)
    traffic = dict(traffic, batch_size=traffic["batch_size"] // 64,
                   fanouts=[5, 5, 5], presample_epochs=2, pad_multiple=64,
                   cache_capacity_per_device=traffic["cache_capacity_per_device"] // 64)
    return cfg, traffic


@contextlib.contextmanager
def small_cells(narrow: bool = False):
    """``run.cell`` returning shrunk cells, for the harness's whole path."""
    real = run.cell

    def cell(workload):
        manifest, entry, cfg, traffic, limits = real(workload)
        return (manifest, entry, *shrink(cfg, traffic, narrow),
                small_limits(workload, limits))

    run.cell = cell
    try:
        yield
    finally:
        run.cell = real
