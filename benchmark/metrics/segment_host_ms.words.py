"""``segment_host_ms``, read as benchmark/metrics/segment_host_ms.py
reads it, in the cells whose rate is ``values_per_s.words``: the word
path's."""

from benchmark import spec

UNIT = "ms"
LAYER = "segment prepare"
MOVES = "values_per_s.words"

read = spec.reader("segment_host_ms").read
