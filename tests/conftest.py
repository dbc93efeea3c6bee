import os
import sys

# src-layout import path (tests run as `PYTHONPATH=src pytest tests/`, but be
# robust when invoked without it).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# NOTE: do NOT set --xla_force_host_platform_device_count here — smoke tests
# and benches must see the real single device; multi-device tests spawn
# subprocesses with their own XLA_FLAGS (see test_distributed.py).


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where none is present")
