"""The benchmark's own tests: ``python -m pytest -q portbench/tests`` on
the CPU; tests marked ``gpu`` skip where there is no CUDA device and run
on the card with the same command."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card with CUDA; skips where there is none")
