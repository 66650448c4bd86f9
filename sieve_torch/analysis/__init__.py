"""Concurrency checks of the port: the runtime half only.

:mod:`sieve_torch.analysis.lockdebug` gives every named lock of the port
a recording wrapper under ``SIEVE_LOCK_DEBUG=1``, and
:mod:`sieve_torch.analysis.model` holds the canonical lock order the
recorded pairs are checked against. Both import only the stdlib.
"""
