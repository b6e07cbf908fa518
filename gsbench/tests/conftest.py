"""The benchmark's own tests, run from the repository's root:

    python -m pytest gsbench/tests          (CPU: small sizes, plain kernels)
    python -m pytest -m cuda gsbench/tests  (on a card)

They import the benchmark and the port from the checkout."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for path in (str(ROOT), str(ROOT / "src")):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels have no CPU mode)")
