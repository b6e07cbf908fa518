import os
import sys

# Make src/ importable without installation (CI runs PYTHONPATH=src, but be
# robust when pytest is invoked bare). NOTE: never set
# xla_force_host_platform_device_count here — smoke tests must see 1 device;
# multi-device tests spawn subprocesses with their own XLA_FLAGS.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's kernels have no CPU mode); "
        "skips without one",
    )
