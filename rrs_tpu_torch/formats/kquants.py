"""The subset of the GGUF block codecs that the port's loader reaches.

Copied from ``rrs_tpu/formats/kquants.py`` (NumPy host code): the Q8_0
wire-format decode (``q8_blocks``), its encoder (``quantize_q8_0``, used by
``Q8Linear.quantize``) and a ``dequantize`` entry for the types the dense
loader meets. F32, F16 and BF16 are views in ``gguf.reader``; every other
quantized type raises ``NotImplementedError`` until its codec is ported.
"""

from __future__ import annotations

import numpy as np

from rrs_tpu_torch.gguf.constants import GGMLType


def _fp16(buf: np.ndarray) -> np.ndarray:
    return buf.view(np.float16).astype(np.float32)


def dequantize_q8_0(raw: np.ndarray, n: int) -> np.ndarray:
    # block: fp16 d + 32 x int8
    blocks = raw.reshape(-1, 34)
    d = _fp16(blocks[:, :2].copy())                     # [nb, 1]
    q = blocks[:, 2:].view(np.int8).astype(np.float32)  # [nb, 32]
    return (q * d).reshape(-1)[:n]


def q8_blocks(raw: np.ndarray, shape) -> tuple[np.ndarray, np.ndarray]:
    """Split a Q8_0 payload for a logical [N, K] tensor into
    (q int8 [N, K], d f32 [N, K//32])."""
    n, k = shape
    blocks = np.ascontiguousarray(raw).reshape(n, k // 32, 34)
    d = blocks[:, :, :2].copy().view(np.float16).astype(np.float32)[:, :, 0]
    q = blocks[:, :, 2:].view(np.int8).reshape(n, k)
    return q, d


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    """quantize_row_q8_0 semantics: d = absmax/127, q = roundf(x/d)."""
    x = np.asarray(x, np.float32).reshape(-1, 32)
    amax = np.abs(x).max(axis=1, keepdims=True)
    d = amax / 127.0
    inv = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip(np.trunc(x * inv + np.copysign(0.5, x * inv)), -128, 127).astype(np.int8)
    d16 = d.astype(np.float16)
    out = np.empty((x.shape[0], 34), np.uint8)
    out[:, :2] = d16.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


def dequantize(raw: np.ndarray, ggml_type: GGMLType, shape: tuple[int, ...]) -> np.ndarray:
    """Dequantize a raw GGUF tensor payload to f32 in its logical shape."""
    n = 1
    for s in shape:
        n *= s
    if ggml_type == GGMLType.Q8_0:
        return dequantize_q8_0(raw, n).reshape(shape)
    raise NotImplementedError(
        f"no dequantizer for {ggml_type!r} in rrs_tpu_torch yet")
