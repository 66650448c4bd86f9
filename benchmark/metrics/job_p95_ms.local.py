"""The 95th percentile of the local run's job wall times over the traced
window (sieve_torch/coordinator.py ``run_local``, host clock). Its spread
from run to run on the card's host is too wide for an end-to-end bound
(PERF.md), so it stands here beside the rate it moves."""

from benchmark.harness import p95

UNIT = "ms"
LAYER = "local run"
MOVES = "values_per_s"


def read(r):
    return p95(r.job_ms) if r.job_ms else None
