"""``device_idle_pct``, read as benchmark/metrics/device_idle_pct.py
reads it, in the cells whose rate is ``values_per_s.words``: the word
path's."""

from benchmark import spec

UNIT = "%"
LAYER = "device"
MOVES = "values_per_s.words"

read = spec.reader("device_idle_pct").read
