"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
checkout's root. Tests marked ``card`` need a CUDA card and skip
without one; each decides that inside the test."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
