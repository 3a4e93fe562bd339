"""The subset of the GGUF block codecs that the port's loader reaches.

Copied from ``rrs_tpu/formats/kquants.py`` (NumPy host code): the Q8_0
wire-format decode (``q8_blocks``), its encoder (``quantize_q8_0``, used by
``Q8Linear.quantize``) and a ``dequantize`` entry for the types the dense
loader meets: Q8_0, and TCQ4_K32 back to the original (unrotated) domain, as a
quantized MoE router arrives. F32, F16 and BF16 are views in ``gguf.reader``;
every other quantized type raises ``NotImplementedError`` until its codec is
ported.
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


def dequantize_tcq4(raw: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """A TCQ4_K32 payload for a logical [N, K] weight (or a stack [E, N, K] of
    per-expert payloads) -> f32 in the original domain: the int4 codes times
    the group scales (plus the zero terms of an asymmetric tile), the inverse
    block FWHT and the inverse channel permutation, as the JAX package's
    ``dequantize_tcq4(rotated=False)``."""
    from rrs_tpu_torch.formats.fwht import fwht_np
    from rrs_tpu_torch.formats.tcq4 import GROUP_SIZE, GROUPS_PER_TILE, TILE_K, unpack_nibbles
    from rrs_tpu_torch.formats.tile_codec import decode_tcq4_gguf

    if len(shape) == 3:
        per = raw.size // shape[0]
        return np.stack([dequantize_tcq4(raw[e * per:(e + 1) * per], shape[1:])
                         for e in range(shape[0])])
    t = decode_tcq4_gguf(raw, shape)
    q = unpack_nibbles(t.qs).astype(np.float32)                       # [K, N]
    k, n = q.shape
    rep = lambda a: np.repeat(a.astype(np.float32), GROUPS_PER_TILE,   # noqa: E731
                              axis=0).reshape(k // GROUP_SIZE, 1, n)
    w = q.reshape(k // GROUP_SIZE, GROUP_SIZE, n) * (
        rep(t.S) * t.sc.astype(np.float32).reshape(k // GROUP_SIZE, 1, n) / 127.0)
    if t.zc is not None:
        w = w + rep(t.Z) * t.zc.astype(np.float32).reshape(k // GROUP_SIZE, 1, n) / 127.0
    w = fwht_np(w.reshape(k // TILE_K, TILE_K, n), axis=1).astype(np.float32).reshape(k, n)
    if t.perm is not None:
        inv = np.empty_like(t.perm)
        inv[t.perm] = np.arange(k, dtype=t.perm.dtype)
        w = w[inv, :]
    return np.ascontiguousarray(w.T.reshape(shape))


def dequantize(raw: np.ndarray, ggml_type: GGMLType, shape: tuple[int, ...]) -> np.ndarray:
    """Dequantize a raw GGUF tensor payload to f32 in its logical shape."""
    if ggml_type == GGMLType.TCQ4_K32:
        return dequantize_tcq4(raw, shape)
    n = 1
    for s in shape:
        n *= s
    if ggml_type == GGMLType.Q8_0:
        return dequantize_q8_0(raw, n).reshape(shape)
    raise NotImplementedError(
        f"no dequantizer for {ggml_type!r} in rrs_tpu_torch yet")
