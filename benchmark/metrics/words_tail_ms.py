"""The word kernel's tail per job: the device span ``words.tail``
(sieve_torch/kernels/word_mark.py: corrections, validity mask, popcount,
pair splice and boundary words, ``reduce.reduce_packed``), read as
benchmark/metrics/words_tier1_ms.py reads tier 1."""

from benchmark import spec

UNIT = "ms"
LAYER = "word kernel"
MOVES = "values_per_s.words"

_per_job = spec.reader("words_tier1_ms").per_job


def read(r):
    return _per_job(r, "words.tail")
