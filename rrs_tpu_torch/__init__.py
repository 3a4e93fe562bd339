"""rrs_tpu_torch: the W4A4 inference engine on PyTorch and CUDA for Hopper.

A port of the JAX package ``rrs_tpu`` (kept beside it as the reference).
Module names mirror ``rrs_tpu``; every Pallas kernel on the ported path is a
hand-written CUDA kernel in ``csrc/``, built with nvcc at first use
(``kernels.py``, which has no counterpart in ``rrs_tpu``). Entry points run
on ``cuda`` unless asked for the CPU.
"""
