"""The benchmark of ``sieve_torch``, the PyTorch and CUDA port.

``run.py`` runs one cell once (see BENCHMARK.json at the checkout's
root); ``control.py`` runs the check's control at a cell's size. The
harness imports the port, never JAX or the JAX package; the plain
reference under ``reference/`` imports neither, nor the port.
"""
