"""A job's fixed host cost: the seed sieve, the plan and the merge
(the spans ``run.seed``, ``run.plan`` and ``run.merge`` of
sieve_torch/coordinator.py and sieve_torch/parallel/mesh.py, with
sieve_torch/seed.py under the first), over the window, divided by its
jobs."""

UNIT = "ms"
LAYER = "job set-up and merge"
MOVES = "values_per_s"


def read(r):
    if not r.jobs:
        return None
    s = sum(r.spans.get(k, (0.0, 0))[0] for k in ("run.seed", "run.plan", "run.merge"))
    return 1e3 * s / r.jobs
