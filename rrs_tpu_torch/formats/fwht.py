"""Walsh-Hadamard transform: the "R" of Rotated Runtime Smooth.

Copied host code from ``rrs_tpu/formats/fwht.py``: the butterfly
``fwht_np`` (the oracle for host-side weight quantization) and the dense
normalized ``hadamard_matrix`` whose f32 matmul rotates activations at run
time (``models.linear.rotate_activations``).
"""

from __future__ import annotations

import functools

import numpy as np

# FWHT is applied independently to each 256-wide chunk of the K axis.
RRS_BLOCK = 256


def fwht_np(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Normalized FWHT over ``axis`` (length must be a power of two). NumPy, host-side."""
    x = np.moveaxis(np.asarray(x, dtype=np.float64), axis, -1)
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"FWHT length must be a power of two, got {n}")
    h = 1
    while h < n:
        x = x.reshape(*x.shape[:-1], n // (2 * h), 2, h)
        a = x[..., 0, :]
        b = x[..., 1, :]
        x = np.concatenate([a + b, a - b], axis=-1).reshape(*x.shape[:-3], n)
        h *= 2
    x = x / np.sqrt(n)
    return np.moveaxis(x, -1, axis)


@functools.lru_cache(maxsize=8)
def _hadamard_np(n: int) -> np.ndarray:
    """Sylvester Hadamard matrix of order n (power of two), entries ±1, float64."""
    if n & (n - 1):
        raise ValueError(f"Hadamard order must be a power of two, got {n}")
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def hadamard_matrix(n: int = RRS_BLOCK, normalized: bool = True) -> np.ndarray:
    """Dense Hadamard matrix; ``x @ hadamard_matrix(n)`` == ``fwht_np(x)`` when normalized.

    The Sylvester H is symmetric, so left and right application agree.
    """
    h = _hadamard_np(n).copy()
    if normalized:
        h /= np.sqrt(n)
    return h
