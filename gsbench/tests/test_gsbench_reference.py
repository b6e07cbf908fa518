"""The reference against the port's plain CPU path at a small graph: the
same draws, and the checked steps' numbers within the cells' limits."""
import json

import numpy as np
import pytest
import torch
from conftest import ROOT
from small import shrink, small_limits

from gsbench import run
from gsbench.data.rmat import make_graph
from gsbench.reference import gnn as reference

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["split", "dp"])
def test_reference_draws_what_the_program_draws(mode):
    from repro_torch.graph.csr import CSRGraph
    from repro_torch.graph.sampling import NeighborSampler

    _, _, cfg, traffic, _ = run.cell("sage-papers256k-split")
    cfg, traffic = shrink(cfg, traffic)
    traffic = dict(traffic, mode=mode)
    seed = 2**31 + 12345
    graph = make_graph(cfg, seed)
    sampler = NeighborSampler(CSRGraph(graph.indptr, graph.indices), graph.train_ids,
                              traffic["fanouts"], traffic["batch_size"], seed=seed)
    for epoch in (0, 1):
        ours = reference.epoch_targets(graph.train_ids, traffic["batch_size"], seed, epoch)
        theirs = sampler.epoch_targets(epoch)
        assert len(ours) == len(theirs)
        for index in (0, len(ours) - 1):
            assert np.array_equal(ours[index], theirs[index])
            mine = reference.step_samples(graph, traffic, seed, epoch, index, ours[index])
            if mode == "split":
                prog = [sampler.sample_batch(theirs[index], epoch, index)]
            else:
                prog = sampler.sample_micro_batch(theirs[index], traffic["num_devices"],
                                                  epoch, index)
            for a, b in zip(mine, prog, strict=True):
                for fa, fb in zip(a["frontiers"], b.frontiers, strict=True):
                    assert np.array_equal(fa, fb)
                for (src, dst), layer in zip(a["hops"], b.layers, strict=True):
                    ours_e = sorted(zip(src.tolist(), dst.tolist()))
                    assert ours_e == sorted(zip(layer.src.tolist(), layer.dst.tolist()))


@pytest.mark.parametrize("cell", CELLS)
def test_program_within_limits_and_control_outside(cell, monkeypatch):
    """The port's checked steps on the CPU read within the cell's limits at
    this size; the reference in TF32 (the control) reads outside at least
    one."""
    from gsbench import control

    real = run.cell

    def small(workload):
        manifest, entry, cfg, traffic, limits = real(workload)
        return (manifest, entry, *shrink(cfg, traffic),
                small_limits(workload, limits))

    monkeypatch.setattr(run, "cell", small)
    out = control.readings(cell, 2**31 + 7, "cpu", with_faults=False)
    limits = run.cell(cell)[4]
    limits.pop("reference", None)
    prog = {k: out["program"][k] for k in limits}
    assert all(prog[k] <= limits[k] for k in limits), (prog, limits)
    ctrl = {k: out["control"][k] for k in limits}
    assert any(ctrl[k] > limits[k] for k in limits), (ctrl, limits)
