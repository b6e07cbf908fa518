"""What the harness imports, checked in fresh processes by top-level module
name (the part before the first dot, compared whole: ``repro_torch`` is the
port, ``repro`` the JAX package)."""
import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

HARNESS = """
import importlib, json, pathlib, sys
sys.path[:0] = [{root!r}, {src!r}]
import gsbench.run, gsbench.control, gsbench.faults, gsbench.trace
import gsbench.drivers.gnn_train
# what the driver imports of the port when it runs
import repro_torch.train.trainer, repro_torch.runtime.plan_source
import repro_torch.models.gnn.layers, repro_torch.graph.datasets
for path in sorted(pathlib.Path({root!r}, "gsbench", "metrics").glob("*.py")):
    gsbench.run.reader(path.stem)
for name in ("gss_fwd", "gss_bwd_mixed", "gss_bwd_w", "shuffle_bwd", "step", "peaks"):
    importlib.import_module("gsbench.counts." + name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}]
import gsbench.reference.gnn, gsbench.data.rmat, gsbench.data.weights
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code.format(root=str(ROOT), src=str(ROOT / "src"))],
        capture_output=True, text=True, check=True, timeout=300, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_imports_no_jax_and_no_jax_package():
    mods = top_level_modules(HARNESS)
    assert "repro_torch" in mods and "torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    mods = top_level_modules(REFERENCE)
    assert "torch" in mods
    assert not mods & (FORBIDDEN | {"repro_torch"}), mods


def test_a_whole_run_imports_no_jax(tmp_path):
    """A small run of every driver path in one process, then the look the
    harness makes after its window."""
    code = f"""
import sys, time
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}, {str(ROOT / 'gsbench' / 'tests')!r}]
import torch
torch.set_num_threads(2)
from gsbench import run
from small import small_cells
with small_cells(narrow=True):
    r, _ = run.run_cell("gat-papers256k-split", 12345, 0.2, True, "cpu", time.perf_counter())
print("FOUND", run.forbidden_modules(), r["correct"])
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND [] True" in out.stdout, out.stdout[-2000:]
