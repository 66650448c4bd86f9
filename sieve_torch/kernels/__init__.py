"""Host spec preparation and the hand-written device kernels.

``specs`` builds marking specs on the host; ``cuda_mark`` groups them
into the fused kernel's tables and wraps the kernel of
``csrc/fused_mark.cu``, which ``build`` compiles with nvcc at first use.
"""
