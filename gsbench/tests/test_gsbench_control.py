"""A whole run of each cell, on the CPU at a small size, with the timed
path broken underneath: the check has to come out as not correct for every
fault the cell can have, and as correct without one. The card's look is the
one step of a run this skips (``run_cell`` is what ``main`` calls after it).
The control (the reference in TF32) is held in ``test_gsbench_reference``."""
import json
import time

import pytest
import torch
from conftest import ROOT
from small import small_cells

from gsbench import faults, run

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CASES = [(w["name"], f) for w in MANIFEST["workloads"]
         for f in (None,) + faults.faults_of(
             json.loads((ROOT / "gsbench" / "traffic" / f"{w['traffic']}.json").read_text()))]


@pytest.mark.parametrize("cell,fault", CASES)
def test_run_is_correct_only_without_a_fault(cell, fault):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with small_cells():
            if fault is None:
                result, _ = run.run_cell(cell, 2**31 + 99, 0.2, False, "cpu",
                                      time.perf_counter())
            else:
                with faults.planted(fault):
                    result, _ = run.run_cell(cell, 2**31 + 99, 0.2, False, "cpu",
                                          time.perf_counter())
    finally:
        torch.set_num_threads(threads)
    assert result["correct"] is (fault is None), (fault, result["checks"])
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
