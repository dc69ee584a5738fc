"""The benchmark's own tests: `python -m pytest sdrbench/tests -q` from
the root of the repository (CPU, a few minutes); the `gpu`-marked ones
run where a CUDA card is and skip elsewhere."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")
