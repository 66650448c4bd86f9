"""The word kernel's tier 1 per job: the device span ``words.tier1``
(sieve_torch/kernels/word_mark.py: the fill and the periodic pattern
ANDs), timed on the card by CUDA events, over the window, divided by its
jobs. None where the program has no such span."""

UNIT = "ms"
LAYER = "word kernel"
MOVES = "values_per_s.words"


def per_job(r, span):
    s, n = r.spans.get(span, (0.0, 0))
    return 1e3 * s / r.jobs if n and r.jobs else None


def read(r):
    return per_job(r, "words.tier1")
