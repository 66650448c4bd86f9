"""The benchmark's plain reference: what a sieve run must answer.

NumPy only, and independent of the program under test: it imports
nothing of ``sieve_torch``, of the JAX package or of JAX, and takes no
table the program built. From N, the packing and the segment count it
plans the segments itself (``common.plan``), sieves a segment with its
own segmented sieve (``packing_<name>.summarize``), reads the 32 flag bits
at each end of every segment (``packing_<name>.boundary_words``), and
counts pi(N) by the Lucy-Hedgehog recursion (``common.prime_pi``), which
shares no code path with any sieve.

A packing's flag layout is one module, ``packing_<packing>.py``, found by
name, so a new packing is a new file.
"""

from __future__ import annotations

import importlib


def packing(name: str):
    """The reference module of one packing (``packing_<name>.py``)."""
    try:
        return importlib.import_module(f"benchmark.reference.packing_{name}")
    except ModuleNotFoundError:
        raise ValueError(f"the reference has no packing {name!r}") from None
