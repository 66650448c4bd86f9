"""``job_fixed_ms``, read as benchmark/metrics/job_fixed_ms.py reads it,
in the cells whose rate is ``values_per_s.words``: the word path's."""

from benchmark import spec

UNIT = "ms"
LAYER = "job set-up and merge"
MOVES = "values_per_s.words"

read = spec.reader("job_fixed_ms").read
