"""TCQ4_K32: the W4A4 RRS format, K-major device layout.

Port of ``rrs_tpu/formats/tcq4.py``. The host side (``TCQ4Tensor``, the
quantizer with its channel permutation, scale search and native route,
``dequantize_tcq4``, ``effective_scales``, the nibble codec) is copied NumPy;
the run-time activation quantizer is torch.

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
TILE_CHANNELS = 8     # rows quantized together (row-group granularity)
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


def _tcq4_search_encode(g: np.ndarray, scales0: np.ndarray):
    """Least-squares scale search per 32-group (make_qx_quants-style): for
    each trial scale, quantize, refit the scale in closed form (s* =
    <x,q>/<q,q>) and keep the least-MSE assignment; then couple the tile
    (S = max group scale in fp16, sc its int8 ratio) and requantize against
    the representable scale. Returns (q [..,8,32] i8, sc [..,8] i8, S [..]
    f32, tile error) for best-of selection against the RTN formula."""
    absmax = np.abs(g).max(axis=-1)
    best_err = None
    best_q = None
    best_s = None
    for d in np.linspace(-1.0, 1.0, 21):
        s_t = absmax / (7.0 + d)
        s_t = np.where(s_t < SCALE_EPS, 1.0, s_t)
        q_t = np.clip(round_half_away(g / s_t[..., None]), -8, 7)
        num = (g * q_t).sum(axis=-1)
        den = (q_t * q_t).sum(axis=-1)
        s_star = np.where(den > 0, num / np.maximum(den, 1e-12), scales0)
        s_star = np.where(s_star > SCALE_EPS, s_star, scales0)
        err = ((g - s_star[..., None] * q_t) ** 2).sum(axis=-1)
        if best_err is None:
            best_err, best_q, best_s = err, q_t, s_star
        else:
            take = err < best_err
            best_err = np.where(take, err, best_err)
            best_q = np.where(take[..., None], q_t, best_q)
            best_s = np.where(take, s_star, best_s)
    S = best_s.max(axis=-1)
    S = np.where(S > 0.0, S, 1.0).astype(np.float32)
    S = S.astype(np.float16).astype(np.float32)       # f16 storage rounding
    sc = np.clip(round_half_away(best_s / S[..., None] * 127.0), -127, 127)
    sc = np.where((sc == 0) & (absmax > 0), 1.0, sc).astype(np.int8)
    eff = S[..., None] * sc.astype(np.float32) / 127.0
    safe = np.where(np.abs(eff) < SCALE_EPS, 1.0, eff)
    q = np.clip(round_half_away(g / safe[..., None]), -8, 7).astype(np.int8)
    err = ((g - eff[..., None] * q) ** 2).sum(axis=(-1, -2))
    return q, sc, S, err


def quantize_tcq4(w: np.ndarray, perm: Optional[np.ndarray] = None,
                  imatrix: Optional[np.ndarray] = None, use_native: bool = True,
                  search: bool = False) -> TCQ4Tensor:
    """Quantize a weight [N, K] to TCQ4 on the host, as the JAX package's
    ``quantize_tcq4``.

    ``perm`` (int [K], block-local) reorders K before the rotation;
    ``imatrix`` is accepted and ignored, as by the reference tile quantizer
    (it only shapes ``perm``). ``search`` runs the least-squares scale
    search and keeps, per tile, whichever of it and the RTN formula has the
    lower error. Without ``search``, and with N a multiple of 8, the native
    host codec quantizes (an f32 FWHT) where it builds; the NumPy path runs
    the FWHT in f64 and can round a tile differently (ROADMAP queue C).
    """
    from rrs_tpu_torch.formats.fwht import fwht_np

    del imatrix
    w = np.asarray(w, dtype=np.float32)
    if use_native and not search and w.shape[0] % TILE_CHANNELS == 0:
        from rrs_tpu_torch import native

        if native.available():
            wp = w if perm is None else w[:, np.asarray(perm, np.int64)]
            qs, sc, S = native.tcq4_quantize(wp)
            return TCQ4Tensor(qs=qs, sc=sc, S=S,
                              perm=None if perm is None else np.asarray(perm, np.int32))
    n_rows, k = w.shape
    if k % TILE_K:
        raise ValueError(f"TCQ4 requires K % 256 == 0, got K={k}")
    if n_rows % TILE_CHANNELS:
        # zero-pad the partial 8-row group; the stored N drops the padding
        w = np.concatenate([w, np.zeros((TILE_CHANNELS - n_rows % TILE_CHANNELS, k),
                                        np.float32)], axis=0)
    if perm is not None:
        perm = np.asarray(perm, dtype=np.int32)
        w = w[:, perm]
    rot = fwht_np(w.reshape(w.shape[0], k // TILE_K, TILE_K), axis=-1).astype(np.float32)
    g = rot.reshape(w.shape[0], k // TILE_K, GROUPS_PER_TILE, GROUP_SIZE)
    scales = np.abs(g).max(axis=-1) / 7.0
    scales = np.where(scales < SCALE_EPS, 1.0, scales).astype(np.float32)
    S_f = scales.max(axis=-1)
    S_f = np.where(S_f > 0.0, S_f, 1.0).astype(np.float32)
    sc = np.clip(round_half_away(scales / S_f[..., None] * 127.0), -127, 127).astype(np.int8)
    q = np.clip(round_half_away(g / scales[..., None]), -8, 7).astype(np.int8)
    if search:
        q2, sc2, S2, err2 = _tcq4_search_encode(g, scales)
        eff_b = (S_f.astype(np.float16).astype(np.float32)[..., None]
                 * sc.astype(np.float32) / 127.0)
        err_b = ((g - eff_b[..., None] * q.astype(np.float32)) ** 2).sum(axis=(-1, -2))
        take = err2 < err_b                           # per tile
        q = np.where(take[..., None, None], q2, q)
        sc = np.where(take[..., None], sc2, sc)
        S_f = np.where(take, S2, S_f).astype(np.float32)
    n_pad = w.shape[0]
    q_kn = q.reshape(n_pad, k).T
    sc_kn = np.ascontiguousarray(sc.reshape(n_pad, k // GROUP_SIZE).T)
    S_kn = np.ascontiguousarray(S_f.reshape(n_pad, k // TILE_K).T)
    return TCQ4Tensor(
        qs=np.ascontiguousarray(pack_nibbles(q_kn)[:, :n_rows]),
        sc=np.ascontiguousarray(sc_kn[:, :n_rows]),
        S=np.ascontiguousarray(S_kn[:, :n_rows]).astype(np.float16),
        perm=perm,
    )


def dequantize_tcq4(t: TCQ4Tensor, rotated: bool = True) -> np.ndarray:
    """Dequantize to f32 [K, N]: in the FWHT domain (``rotated``, the
    operand the matmul consumes), or with the inverse FWHT and the inverse
    channel permutation applied (the original-domain weight)."""
    from rrs_tpu_torch.formats.fwht import fwht_np

    q = unpack_nibbles(t.qs).astype(np.float32)                    # [K, N]
    k, n = q.shape
    sc = t.sc.astype(np.float32).reshape(k // GROUP_SIZE, 1, n)
    S = np.repeat(t.S.astype(np.float32), GROUPS_PER_TILE, axis=0).reshape(k // GROUP_SIZE, 1, n)
    w = q.reshape(k // GROUP_SIZE, GROUP_SIZE, n) * (S * sc / 127.0)
    if t.zc is not None:
        zc = t.zc.astype(np.float32).reshape(k // GROUP_SIZE, 1, n)
        Z = np.repeat(t.Z.astype(np.float32), GROUPS_PER_TILE, axis=0).reshape(
            k // GROUP_SIZE, 1, n)
        w = w + Z * zc / 127.0
    w = w.reshape(k, n)
    if not rotated:
        w = fwht_np(w.reshape(k // TILE_K, TILE_K, n), axis=1).astype(np.float32).reshape(k, n)
        if t.perm is not None:
            inv = np.empty_like(t.perm)
            inv[t.perm] = np.arange(k, dtype=t.perm.dtype)
            w = w[inv, :]
    return w.astype(np.float32)


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
    # a true division, as jnp and the gx2 kernel compute 7 / amax: torch's
    # ``7.0 / tensor`` is 7 * (1 / amax), one rounding more, and can move a
    # code across a half-way point
    q = torch.round(xb * torch.div(torch.full_like(amax, 7.0), amax)[..., None])
    q = q.clamp(-7, 7).to(torch.int8)
    return q.reshape(*lead, k), amax


def dequantize_activations_rrs(q: torch.Tensor, a_scale: torch.Tensor) -> torch.Tensor:
    """Inverse of quantize_activations_rrs (rotated domain): a = q * scale / 7."""
    k = q.shape[-1]
    lead = q.shape[:-1]
    qb = q.reshape(*lead, k // TILE_K, TILE_K).to(torch.float32)
    return (qb * (a_scale / 7.0)[..., None]).reshape(*lead, k)
