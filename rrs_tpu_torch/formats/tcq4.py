"""TCQ4_K32: the W4A4 RRS format, K-major device layout.

Port of ``rrs_tpu/formats/tcq4.py``. The host side (``TCQ4Tensor``,
``effective_scales``, the nibble codec) is copied NumPy; the run-time
activation quantizer is torch.

Weight layout (K-major, so the dequantized operand is [K, N]):

    qs : uint8 [K//2, N]   byte (kb*128 + j, n) holds q[kb*256 + j] in the low
                           nibble and q[kb*256 + 128 + j] in the high nibble,
                           both sign-extended to [-8, 7]
    sc : int8  [K//32, N]  per-group scale codes
    S  : fp16  [K//256, N] per-superblock super-scales

Activations: per 256-block a_scale = max|x| (< 1e-10 -> 1.0),
q_a = clip(rint(x * (7 / a_scale)), -7, 7), dequant a = q_a * a_scale / 7.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

TILE_K = 256          # K per superblock
GROUP_SIZE = 32       # elements per scale group
GROUPS_PER_TILE = TILE_K // GROUP_SIZE
SCALE_EPS = 1e-10


@dataclasses.dataclass
class TCQ4Tensor:
    """A TCQ4-quantized 2-D weight on the host, K-major layout.

    Logical weight is [N, K] (N output channels); arrays are stored so that the
    dequantized matmul operand is [K, N].
    """

    qs: np.ndarray          # uint8 [K//2, N]
    sc: np.ndarray          # int8  [K//32, N]
    S: np.ndarray           # fp16  [K//256, N]
    perm: Optional[np.ndarray] = None   # int32 [K], block-local channel perm
    zc: Optional[np.ndarray] = None     # int8  [K//32, N] (zero codes; rarely used)
    Z: Optional[np.ndarray] = None      # fp16  [K//256, N]

    @property
    def K(self) -> int:
        return self.qs.shape[0] * 2

    @property
    def N(self) -> int:
        return self.qs.shape[1]


def round_half_away(x: np.ndarray) -> np.ndarray:
    """C roundf(): round half away from zero (numpy rounds half to even)."""
    return np.trunc(x + np.copysign(0.5, x))


def quantize_tcq4(w: np.ndarray) -> TCQ4Tensor:
    """Quantize a weight [N, K] to TCQ4 on the host (the reference RTN
    formula of ``rrs_tpu/formats/tcq4.py:quantize_tcq4`` with its f64 NumPy
    FWHT; the perm, imatrix and scale-search options are not ported)."""
    from rrs_tpu_torch.formats.fwht import fwht_np

    w = np.asarray(w, dtype=np.float32)
    n_rows, k = w.shape
    if k % TILE_K:
        raise ValueError(f"TCQ4 requires K % 256 == 0, got K={k}")
    if n_rows % 8:
        w = np.concatenate([w, np.zeros((8 - n_rows % 8, k), np.float32)], axis=0)
    rot = fwht_np(w.reshape(w.shape[0], k // TILE_K, TILE_K), axis=-1).astype(np.float32)
    g = rot.reshape(w.shape[0], k // TILE_K, GROUPS_PER_TILE, GROUP_SIZE)
    scales = np.abs(g).max(axis=-1) / 7.0
    scales = np.where(scales < SCALE_EPS, 1.0, scales).astype(np.float32)
    S_f = scales.max(axis=-1)
    S_f = np.where(S_f > 0.0, S_f, 1.0).astype(np.float32)
    sc = np.clip(round_half_away(scales / S_f[..., None] * 127.0), -127, 127).astype(np.int8)
    q = np.clip(round_half_away(g / scales[..., None]), -8, 7).astype(np.int8)
    n_pad = w.shape[0]
    q_kn = q.reshape(n_pad, k).T
    sc_kn = np.ascontiguousarray(sc.reshape(n_pad, k // GROUP_SIZE).T)
    S_kn = np.ascontiguousarray(S_f.reshape(n_pad, k // TILE_K).T)
    return TCQ4Tensor(
        qs=np.ascontiguousarray(pack_nibbles(q_kn)[:, :n_rows]),
        sc=np.ascontiguousarray(sc_kn[:, :n_rows]),
        S=np.ascontiguousarray(S_kn[:, :n_rows]).astype(np.float16),
    )


def effective_scales(t: TCQ4Tensor) -> np.ndarray:
    """f32 [K//32, N] per-group effective scale fp32(fp16(S)) * sc / 127."""
    S_rep = np.repeat(t.S.astype(np.float32), GROUPS_PER_TILE, axis=0)
    return S_rep * t.sc.astype(np.float32) / 127.0


def pack_nibbles(q: np.ndarray) -> np.ndarray:
    """Pack int4 values q [K, N] (in [-8, 7]) into uint8 [K//2, N] per superblock."""
    k, n = q.shape
    assert k % TILE_K == 0
    u = (q.astype(np.int16) & 0xF).astype(np.uint8)
    u = u.reshape(k // TILE_K, 2, TILE_K // 2, n)
    return (u[:, 0] | (u[:, 1] << 4)).reshape(k // 2, n)


def unpack_nibbles(qs: np.ndarray) -> np.ndarray:
    """Inverse of pack_nibbles: uint8 [K//2, N] -> int8 [K, N] in [-8, 7]."""
    kh, n = qs.shape
    k = kh * 2
    assert k % TILE_K == 0
    b = qs.reshape(k // TILE_K, TILE_K // 2, n)
    lo = (b & 0xF).astype(np.int8)
    hi = (b >> 4).astype(np.int8)
    out = np.stack([lo, hi], axis=1).reshape(k // TILE_K, TILE_K, n)
    out = np.where(out >= 8, out - 16, out)
    return out.reshape(k, n).astype(np.int8)


def unpack_nibbles_torch(qs: torch.Tensor) -> torch.Tensor:
    """Device twin of ``unpack_nibbles``: uint8 [K//2, N] -> int32 [K, N]
    by sign-extending shifts (low nibble = k, high nibble = k + 128)."""
    kh, n = qs.shape
    q3 = qs.reshape(kh // (TILE_K // 2), TILE_K // 2, n).to(torch.int32)
    lo = (q3 << 28) >> 28
    hi = (q3 << 24) >> 28
    return torch.cat([lo, hi], dim=1).reshape(2 * kh, n)


def quantize_activations_rrs(x_rot: torch.Tensor):
    """Quantize already-rotated activations [..., K] to int4-in-int8 + scales.

    Returns (q [..., K] int8 in [-7, 7], a_scale [..., K//256] f32). Bit-exact
    with the JAX quantizer: ``x * (7 / amax)`` then round-half-to-even
    (``torch.round`` like ``jnp.rint``), then clip.
    """
    k = x_rot.shape[-1]
    if k % TILE_K:
        raise ValueError(f"activation width {k} is not a multiple of {TILE_K}")
    lead = x_rot.shape[:-1]
    xb = x_rot.reshape(*lead, k // TILE_K, TILE_K).to(torch.float32)
    amax = xb.abs().amax(dim=-1)
    amax = torch.where(amax < SCALE_EPS, torch.ones_like(amax), amax)
    q = torch.round(xb * (7.0 / amax)[..., None])
    q = q.clamp(-7, 7).to(torch.int8)
    return q.reshape(*lead, k), amax


def dequantize_activations_rrs(q: torch.Tensor, a_scale: torch.Tensor) -> torch.Tensor:
    """Inverse of quantize_activations_rrs (rotated domain): a = q * scale / 7."""
    k = q.shape[-1]
    lead = q.shape[:-1]
    qb = q.reshape(*lead, k // TILE_K, TILE_K).to(torch.float32)
    return (qb * (a_scale / 7.0)[..., None]).reshape(*lead, k)
