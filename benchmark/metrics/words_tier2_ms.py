"""The word kernel's tier 2 per job: the device span ``words.tier2``
(sieve_torch/kernels/word_mark.py: the table upload and the
remainder/shift/OR blocks), read as benchmark/metrics/words_tier1_ms.py
reads tier 1."""

from benchmark import spec

UNIT = "ms"
LAYER = "word kernel"
MOVES = "values_per_s.words"

_per_job = spec.reader("words_tier1_ms").per_job


def read(r):
    return _per_job(r, "words.tier2")
