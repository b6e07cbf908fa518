"""On a card: one short traced run of the cheapest cell through the
command, its result line read as the driver reads it."""
import json
import subprocess
import sys

import pytest
import torch
from conftest import ROOT


@pytest.mark.cuda
def test_traced_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the run refuses the CPU")
    out = subprocess.run(
        [sys.executable, "-m", "gsbench", "--workload", "sage-papers256k-dp",
         "--seed", str(2**31 + 5), "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert {"device_ops", "idle_gaps"} <= set(result["breakdown"])
    for name in ("gss_fwd_roofline", "gss_bwd_mixed_roofline", "mfu"):
        assert 0 < result["metrics"][name]["value"] <= 105


def test_the_command_refuses_to_run_without_enough_cards():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "gsbench", "--workload", "sage-papers256k-dp",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
