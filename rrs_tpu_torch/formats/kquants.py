"""CPU reference codecs for the llama.cpp block-quant formats found in GGUF
files: every dequantizer of ``_DEQUANT`` and every encoder of the quantize
menu.

Copied host code from ``rrs_tpu/formats/kquants.py`` (vectorized NumPy
restatements of ggml/src/ggml-quants.c: dequantize_row_q8_0,
dequantize_row_q4_K, quantize_row_q4_K, ...). These are load-time codecs:
weights arrive as K-quant, legacy-quant, i-quant, MXFP4, Q8_0 or TCQ4_K32
tensors and are dequantized to f32 for the dense path, or written by the
``quantize`` verb. Q8_0, Q4_K and Q6_K decode through the native host codec
(``rrs_tpu_torch.native``) where it builds.
"""

from __future__ import annotations

import numpy as np

from rrs_tpu_torch.gguf.constants import GGMLType

QK_K = 256


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
    (q int8 [N, K], d f32 [N, K//32]) — the wire-format decode shared by
    Q8Linear.from_q8_gguf and the packed-embedding loader."""
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


def dequantize_q4_0(raw: np.ndarray, n: int) -> np.ndarray:
    # block: fp16 d + 16 bytes; elem j<16 low nibble, j>=16 high nibble; q-8
    blocks = raw.reshape(-1, 18)
    d = _fp16(blocks[:, :2].copy())
    qs = blocks[:, 2:]
    lo = (qs & 0xF).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return (q * d).reshape(-1)[:n]


def _q4k_scale_min(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """get_scale_min_k4 (ggml-quants.c:707-715), vectorized over blocks.

    scales: [nb, 12] uint8 -> (sc, m): [nb, 8] float32, 6-bit values.
    """
    s = scales.astype(np.uint32)
    sc = np.empty(s.shape[:-1] + (8,), np.uint32)
    m = np.empty_like(sc)
    for j in range(4):
        sc[..., j] = s[..., j] & 63
        m[..., j] = s[..., j + 4] & 63
    for j in range(4, 8):
        sc[..., j] = (s[..., j + 4] & 0xF) | ((s[..., j - 4] >> 6) << 4)
        m[..., j] = (s[..., j + 4] >> 4) | ((s[..., j] >> 6) << 4)
    return sc.astype(np.float32), m.astype(np.float32)


def _round_half_away_kq(x: np.ndarray) -> np.ndarray:
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def quantize_q4_k(x: np.ndarray) -> np.ndarray:
    """Q4_K quantizer (quantize_row_q4_K_ref, ggml-quants.c — 256-block
    superblocks of 8x32 sub-blocks, 6-bit scales/mins, asymmetric 4-bit),
    vectorized over all sub-blocks: the make_qkx2_quants weighted
    least-squares scale/min search (rmin=-1, rdelta=0.1, nstep=20) runs as
    a 21-candidate sweep in numpy. Returns the raw 144-byte/block buffer."""
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    assert x.size % 256 == 0, x.size
    nb = x.size // 256
    xb = x.reshape(nb * 8, 32)                  # all sub-blocks [M, 32]

    # weights: av_x + |x| per sub-block
    av = np.sqrt((xb * xb).sum(1) / 32)[:, None]
    wgt = av + np.abs(xb)
    mn = np.minimum(xb.min(1), 0.0)             # min>0 -> 0
    mx = xb.max(1)
    flat = mx == mn                             # degenerate: all L=0, min=-min
    rng = np.where(flat, 1.0, mx - mn)

    sum_w = wgt.sum(1)
    sum_x = (wgt * xb).sum(1)

    def quant_L(iscale, mins):
        l = _round_half_away_kq(iscale[:, None] * (xb - mins[:, None]))
        return np.clip(l, 0, 15)

    def err_of(scale, mins, L):
        diff = scale[:, None] * L + mins[:, None] - xb
        return (wgt * diff * diff).sum(1)

    # initial candidate
    iscale0 = 15.0 / rng
    L_best = quant_L(iscale0, mn)
    scale_best = 1.0 / iscale0
    min_best = mn.copy()
    err_best = err_of(scale_best, min_best, L_best)

    for is_ in range(21):                       # nstep=20 inclusive sweep
        iscale = (-1.0 + 0.1 * is_ + 15.0) / rng
        L = quant_L(iscale, mn)
        sum_l = (wgt * L).sum(1)
        sum_l2 = (wgt * L * L).sum(1)
        sum_xl = (wgt * L * xb).sum(1)
        D = sum_w * sum_l2 - sum_l * sum_l
        with np.errstate(divide="ignore", invalid="ignore"):
            this_scale = (sum_w * sum_xl - sum_x * sum_l) / D
            this_min = (sum_l2 * sum_x - sum_l * sum_xl) / D
            pos = this_min > 0
            this_min = np.where(pos, 0.0, this_min)
            this_scale = np.where(pos, sum_xl / np.maximum(sum_l2, 1e-30),
                                  this_scale)
        ok = D > 0
        cur = err_of(np.nan_to_num(this_scale), np.nan_to_num(this_min), L)
        better = ok & (cur < err_best)
        err_best = np.where(better, cur, err_best)
        scale_best = np.where(better, this_scale, scale_best)
        min_best = np.where(better, this_min, min_best)
        L_best = np.where(better[:, None], L, L_best)

    scale_best = np.where(flat, 0.0, scale_best)
    min_best = np.where(flat, mn, min_best)

    scales = scale_best.reshape(nb, 8)          # positive by construction
    mins = (-min_best).reshape(nb, 8)           # stored min is -min

    max_scale = scales.max(1)
    max_min = np.maximum(mins.max(1), 0.0)
    inv_scale = np.where(max_scale > 0, 63.0 / np.maximum(max_scale, 1e-30), 0.0)
    inv_min = np.where(max_min > 0, 63.0 / np.maximum(max_min, 1e-30), 0.0)
    ls = np.minimum(_round_half_away_kq(inv_scale[:, None] * scales), 63
                    ).astype(np.uint8)
    lm = np.minimum(_round_half_away_kq(inv_min[:, None] * mins), 63
                    ).astype(np.uint8)

    sbytes = np.zeros((nb, 12), np.uint8)
    sbytes[:, 0:4] = ls[:, 0:4]
    sbytes[:, 4:8] = lm[:, 0:4]
    sbytes[:, 8:12] = (ls[:, 4:8] & 0xF) | ((lm[:, 4:8] & 0xF) << 4)
    sbytes[:, 0:4] |= (ls[:, 4:8] >> 4) << 6
    sbytes[:, 4:8] |= (lm[:, 4:8] >> 4) << 6

    d = (max_scale / 63.0).astype(np.float16)
    dmin = (max_min / 63.0).astype(np.float16)

    # final requant with the packed 6-bit scales (matches the ref's second
    # pass through get_scale_min_k4)
    sc, m = _q4k_scale_min(sbytes)
    dd = d.astype(np.float32)[:, None] * sc     # [nb, 8]
    dm = dmin.astype(np.float32)[:, None] * m
    xs = x.reshape(nb, 8, 32)
    with np.errstate(divide="ignore", invalid="ignore"):
        Lq = _round_half_away_kq((xs + dm[..., None]) / dd[..., None])
    Lq = np.where(dd[..., None] != 0, np.clip(Lq, 0, 15), 0).astype(np.uint8)

    qs = np.zeros((nb, 128), np.uint8)
    Lf = Lq.reshape(nb, 256)
    for c in range(4):
        qs[:, c * 32 : (c + 1) * 32] = (Lf[:, c * 64 : c * 64 + 32]
                                        | (Lf[:, c * 64 + 32 : c * 64 + 64] << 4))

    out = np.empty((nb, 144), np.uint8)
    out[:, 0:2] = d.view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = dmin.view(np.uint8).reshape(nb, 2)
    out[:, 4:16] = sbytes
    out[:, 16:144] = qs
    return out.reshape(-1)


def dequantize_q4_k(raw: np.ndarray, n: int) -> np.ndarray:
    # block: fp16 d, fp16 dmin, 12B scales, 128B qs (dequantize_row_q4_K :1643)
    blocks = raw.reshape(-1, 144)
    d = _fp16(blocks[:, 0:2].copy())[:, 0]
    dmin = _fp16(blocks[:, 2:4].copy())[:, 0]
    sc, mn = _q4k_scale_min(blocks[:, 4:16])
    qs = blocks[:, 16:144]                                   # [nb, 128]
    nb = blocks.shape[0]
    out = np.empty((nb, 256), np.float32)
    # j-loop over 64-element chunks: chunk c uses qs[c*32:(c+1)*32],
    # low nibbles -> elements [c*64, c*64+32) scale 2c, high -> +32 scale 2c+1
    for c in range(4):
        q = qs[:, c * 32 : (c + 1) * 32]
        lo = (q & 0xF).astype(np.float32)
        hi = (q >> 4).astype(np.float32)
        out[:, c * 64 : c * 64 + 32] = d[:, None] * sc[:, 2 * c, None] * lo - dmin[:, None] * mn[:, 2 * c, None]
        out[:, c * 64 + 32 : c * 64 + 64] = d[:, None] * sc[:, 2 * c + 1, None] * hi - dmin[:, None] * mn[:, 2 * c + 1, None]
    return out.reshape(-1)[:n]


def _make_qx_quants(xb: np.ndarray, nmax: int,
                    wgt: np.ndarray) -> np.ndarray:
    """Weighted symmetric scale search (make_qx_quants rmse_type=1
    semantics, ggml-quants.c): for each row of ``xb`` [M, G] find the
    float scale d minimizing sum w (x - d*round(x/d))^2 with
    round(x/d) clamped to [-nmax, nmax-1], by sweeping 19 candidate
    inverse scales anchored at the signed absmax. Returns d [M]."""
    m, g = xb.shape
    idx = np.abs(xb).argmax(1)
    smax = xb[np.arange(m), idx]                       # signed extreme
    amax = np.abs(smax)
    live = amax > 1e-30

    def trial(iscale):
        L = np.clip(_round_half_away_kq(iscale[:, None] * xb),
                    -nmax, nmax - 1)
        sumlx = (wgt * xb * L).sum(1)
        suml2 = (wgt * L * L).sum(1)
        return L, sumlx, suml2

    with np.errstate(divide="ignore", invalid="ignore"):
        best_scale = np.zeros(m, np.float32)
        best_obj = np.full(m, -1.0, np.float32)
        for is_ in range(-9, 10):
            iscale = np.where(live, -(nmax + 0.1 * is_) /
                              np.where(live, smax, 1.0), 0.0)
            _, sumlx, suml2 = trial(iscale)
            ok = suml2 > 0
            obj = np.where(ok, sumlx * sumlx / np.maximum(suml2, 1e-30),
                           -1.0)
            better = live & ok & (obj > best_obj)
            best_obj = np.where(better, obj, best_obj)
            best_scale = np.where(better, sumlx / np.maximum(suml2, 1e-30),
                                  best_scale)
    return best_scale.astype(np.float32)


def _qkx_search(xb: np.ndarray, wgt: np.ndarray, nmax: int,
                rmin: float = -1.0, rdelta: float = 0.1,
                nstep: int = 20, use_mad: bool = False):
    """make_qkx2_quants-style asymmetric (scale, min) search, vectorized
    over sub-blocks [M, G]: sweep nstep+1 candidate inverse scales, solve
    the weighted normal equations for (d, m) at each, keep the best.
    ``use_mad`` scores candidates by weighted |err| instead of err^2
    (the Q2_K objective, ggml-quants.c:735). Returns (scale [M],
    neg_min [M] >= 0). Shared by Q4_K (its historical twin lives inline
    in quantize_q4_k), Q5_K and Q2_K."""
    mn = np.minimum(xb.min(1), 0.0)
    mx = xb.max(1)
    flat = mx == mn
    rng = np.where(flat, 1.0, mx - mn)
    sum_w = wgt.sum(1)
    sum_x = (wgt * xb).sum(1)

    def quant_L(iscale, mins):
        return np.clip(_round_half_away_kq(
            iscale[:, None] * (xb - mins[:, None])), 0, nmax)

    def err_of(scale, mins, L):
        diff = scale[:, None] * L + mins[:, None] - xb
        pen = np.abs(diff) if use_mad else diff * diff
        return (wgt * pen).sum(1)

    iscale0 = nmax / rng
    L_best = quant_L(iscale0, mn)
    scale_best = 1.0 / iscale0
    min_best = mn.copy()
    err_best = err_of(scale_best, min_best, L_best)
    for is_ in range(nstep + 1):
        iscale = (rmin + rdelta * is_ + nmax) / rng
        L = quant_L(iscale, mn)
        sum_l = (wgt * L).sum(1)
        sum_l2 = (wgt * L * L).sum(1)
        sum_xl = (wgt * L * xb).sum(1)
        D = sum_w * sum_l2 - sum_l * sum_l
        with np.errstate(divide="ignore", invalid="ignore"):
            this_scale = (sum_w * sum_xl - sum_x * sum_l) / D
            this_min = (sum_l2 * sum_x - sum_l * sum_xl) / D
            pos = this_min > 0
            this_min = np.where(pos, 0.0, this_min)
            this_scale = np.where(pos, sum_xl / np.maximum(sum_l2, 1e-30),
                                  this_scale)
        cur = err_of(np.nan_to_num(this_scale), np.nan_to_num(this_min), L)
        better = (D > 0) & (cur < err_best)
        err_best = np.where(better, cur, err_best)
        scale_best = np.where(better, this_scale, scale_best)
        min_best = np.where(better, this_min, min_best)
    scale_best = np.where(flat, 0.0, scale_best)
    min_best = np.where(flat, mn, min_best)
    return scale_best, -min_best


def _default_wgt(xb: np.ndarray, qw=None) -> np.ndarray:
    """Per-element weights: the imatrix slice when given (llama-quant
    passes the activation second moments straight through), else the
    K-quant default sigma-regularized magnitude weighting."""
    if qw is not None:
        return np.asarray(qw, np.float32).reshape(xb.shape)
    av = np.sqrt((xb * xb).sum(1) / xb.shape[1])[:, None]
    return av + np.abs(xb)


def quantize_q6_k(x: np.ndarray, qw=None) -> np.ndarray:
    """Q6_K encoder (quantize_row_q6_K semantics, ggml-quants.c): 256
    superblocks of 16x16 sub-blocks, int8 sub-scales, fp16 d, 6-bit
    quants split ql/qh. Scale search via _make_qx_quants (imatrix-weighted
    when ``qw`` is given). Returns the raw 210-byte/block buffer."""
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    assert x.size % 256 == 0, x.size
    nb = x.size // 256
    xb = x.reshape(nb * 16, 16)
    wgt = _default_wgt(xb, qw)
    scales = _make_qx_quants(xb, 32, wgt).reshape(nb, 16)

    amax_sc = np.abs(scales).max(1)
    idx = np.abs(scales).argmax(1)
    smax_sc = scales[np.arange(nb), idx]
    live = amax_sc > 1e-30
    iscale = np.where(live, -128.0 / np.where(live, smax_sc, 1.0), 0.0)
    d = (1.0 / np.where(iscale == 0, 1.0, iscale)).astype(np.float16)
    d = np.where(live, d, np.float16(0))
    sc8 = np.clip(_round_half_away_kq(iscale[:, None] * scales),
                  -128, 127).astype(np.int8)

    dsc = d.astype(np.float32)[:, None] * sc8.astype(np.float32)  # [nb,16]
    with np.errstate(divide="ignore", invalid="ignore"):
        L = _round_half_away_kq(x.reshape(nb, 16, 16)
                                / np.where(dsc == 0, 1.0, dsc)[..., None])
    L = np.where(dsc[..., None] != 0, np.clip(L, -32, 31), 0) + 32
    L = L.reshape(nb, 256).astype(np.uint8)                 # 0..63

    ql = np.zeros((nb, 128), np.uint8)
    qh = np.zeros((nb, 64), np.uint8)
    for half in range(2):
        base = half * 128
        q1 = L[:, base:base + 32]
        q2 = L[:, base + 32:base + 64]
        q3 = L[:, base + 64:base + 96]
        q4 = L[:, base + 96:base + 128]
        ql[:, half * 64:half * 64 + 32] = (q1 & 0xF) | ((q3 & 0xF) << 4)
        ql[:, half * 64 + 32:half * 64 + 64] = (q2 & 0xF) | ((q4 & 0xF) << 4)
        qh[:, half * 32:half * 32 + 32] = ((q1 >> 4) | ((q2 >> 4) << 2)
                                           | ((q3 >> 4) << 4)
                                           | ((q4 >> 4) << 6))
    out = np.empty((nb, 210), np.uint8)
    out[:, 0:128] = ql
    out[:, 128:192] = qh
    out[:, 192:208] = sc8.view(np.uint8)
    out[:, 208:210] = d.view(np.uint8).reshape(nb, 2)
    return out.reshape(-1)


def quantize_q5_k(x: np.ndarray, qw=None) -> np.ndarray:
    """Q5_K encoder (quantize_row_q5_K semantics): Q4_K's asymmetric
    6-bit super-scale scheme with 5-bit quants (nmax=31) and the qh
    high-bit plane. Returns the raw 176-byte/block buffer."""
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    assert x.size % 256 == 0, x.size
    nb = x.size // 256
    xb = x.reshape(nb * 8, 32)
    wgt = _default_wgt(xb, qw)
    # quantize_row_q5_K search params (ggml-quants.c:1775): rmin=-0.5,
    # 15 steps (not the Q4_K -1.0/20 defaults).
    scale_b, min_b = _qkx_search(xb, wgt, 31, rmin=-0.5, nstep=15)
    scales = scale_b.reshape(nb, 8)
    mins = min_b.reshape(nb, 8)

    max_scale = scales.max(1)
    max_min = np.maximum(mins.max(1), 0.0)
    inv_scale = np.where(max_scale > 0,
                         63.0 / np.maximum(max_scale, 1e-30), 0.0)
    inv_min = np.where(max_min > 0, 63.0 / np.maximum(max_min, 1e-30), 0.0)
    ls = np.minimum(_round_half_away_kq(inv_scale[:, None] * scales),
                    63).astype(np.uint8)
    lm = np.minimum(_round_half_away_kq(inv_min[:, None] * mins),
                    63).astype(np.uint8)
    sbytes = np.zeros((nb, 12), np.uint8)
    sbytes[:, 0:4] = ls[:, 0:4]
    sbytes[:, 4:8] = lm[:, 0:4]
    sbytes[:, 8:12] = (ls[:, 4:8] & 0xF) | ((lm[:, 4:8] & 0xF) << 4)
    sbytes[:, 0:4] |= (ls[:, 4:8] >> 4) << 6
    sbytes[:, 4:8] |= (lm[:, 4:8] >> 4) << 6
    d = (max_scale / 63.0).astype(np.float16)
    dmin = (max_min / 63.0).astype(np.float16)

    sc, m = _q4k_scale_min(sbytes)
    dd = d.astype(np.float32)[:, None] * sc
    dm = dmin.astype(np.float32)[:, None] * m
    xs = x.reshape(nb, 8, 32)
    with np.errstate(divide="ignore", invalid="ignore"):
        Lq = _round_half_away_kq(
            (xs + dm[..., None]) / np.where(dd == 0, 1.0, dd)[..., None])
    Lq = np.where(dd[..., None] != 0, np.clip(Lq, 0, 31), 0).astype(np.uint8)

    qs = np.zeros((nb, 128), np.uint8)
    qh = np.zeros((nb, 32), np.uint8)
    Lf = Lq.reshape(nb, 256)
    for c in range(4):
        lo5 = Lf[:, c * 64:c * 64 + 32]
        hi5 = Lf[:, c * 64 + 32:c * 64 + 64]
        qs[:, c * 32:(c + 1) * 32] = (lo5 & 0xF) | ((hi5 & 0xF) << 4)
        qh |= ((lo5 >> 4) << (2 * c)) | ((hi5 >> 4) << (2 * c + 1))
    out = np.empty((nb, 176), np.uint8)
    out[:, 0:2] = d.view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = dmin.view(np.uint8).reshape(nb, 2)
    out[:, 4:16] = sbytes
    out[:, 16:48] = qh
    out[:, 48:176] = qs
    return out.reshape(-1)


def quantize_q3_k(x: np.ndarray, qw=None) -> np.ndarray:
    """Q3_K encoder (quantize_row_q3_K semantics): 16x16 sub-blocks,
    symmetric 3-bit quants, 6-bit offset-32 sub-scales packed into 12
    bytes, fp16 d. Returns the raw 110-byte/block buffer."""
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    assert x.size % 256 == 0, x.size
    nb = x.size // 256
    xb = x.reshape(nb * 16, 16)
    wgt = _default_wgt(xb, qw)
    scales = _make_qx_quants(xb, 4, wgt).reshape(nb, 16)

    amax_sc = np.abs(scales).max(1)
    idx = np.abs(scales).argmax(1)
    smax_sc = scales[np.arange(nb), idx]
    live = amax_sc > 1e-30
    iscale = np.where(live, -32.0 / np.where(live, smax_sc, 1.0), 0.0)
    d = np.where(live, (1.0 / np.where(iscale == 0, 1.0, iscale)
                        ).astype(np.float16), np.float16(0))
    sc6 = (np.clip(_round_half_away_kq(iscale[:, None] * scales),
                   -32, 31) + 32).astype(np.uint8)          # [nb,16] 0..63

    # pack 16 6-bit scales into 12 bytes (inverse of the kmask unpack)
    lo4 = sc6 & 0xF
    hi2 = sc6 >> 4
    sb = np.zeros((nb, 12), np.uint8)
    sb[:, 0:8] = lo4[:, 0:8] | (lo4[:, 8:16] << 4)
    for j in range(4):
        sb[:, 8 + j] = (hi2[:, j] | (hi2[:, 4 + j] << 2)
                        | (hi2[:, 8 + j] << 4) | (hi2[:, 12 + j] << 6))

    dsc = d.astype(np.float32)[:, None] * (sc6.astype(np.float32) - 32.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        L = _round_half_away_kq(x.reshape(nb, 16, 16)
                                / np.where(dsc == 0, 1.0, dsc)[..., None])
    L = np.where(dsc[..., None] != 0, np.clip(L, -4, 3), 0) + 4
    L = L.reshape(nb, 256).astype(np.uint8)                 # 0..7

    hmask = np.zeros((nb, 32), np.uint8)
    qs = np.zeros((nb, 64), np.uint8)
    m = 1
    for half in range(2):
        for j in range(4):
            g = L[:, half * 128 + j * 32: half * 128 + (j + 1) * 32]
            hmask |= np.where(g >= 4, m, 0).astype(np.uint8)
            qs[:, half * 32:(half + 1) * 32] |= ((g & 3) << (2 * j)
                                                 ).astype(np.uint8)
            m <<= 1
    out = np.empty((nb, 110), np.uint8)
    out[:, 0:32] = hmask
    out[:, 32:96] = qs
    out[:, 96:108] = sb
    out[:, 108:110] = d.view(np.uint8).reshape(nb, 2)
    return out.reshape(-1)


def quantize_q2_k(x: np.ndarray, qw=None) -> np.ndarray:
    """Q2_K encoder (quantize_row_q2_K semantics): 16x16 sub-blocks,
    asymmetric 2-bit quants with 4-bit sub-scales/mins, fp16 d/dmin.
    Returns the raw 84-byte/block buffer."""
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    assert x.size % 256 == 0, x.size
    nb = x.size // 256
    xb = x.reshape(nb * 16, 16)
    # quantize_row_q2_K (ggml-quants.c:734-736): plain |x| weights (not
    # the sigma-regularized default) and a MAD objective (use_mad=true).
    wgt = (np.asarray(qw, np.float32).reshape(xb.shape) if qw is not None
           else np.abs(xb))
    scale_b, min_b = _qkx_search(xb, wgt, 3, rmin=-0.5, rdelta=0.1,
                                 nstep=15, use_mad=True)
    scales = scale_b.reshape(nb, 16)
    mins = min_b.reshape(nb, 16)

    max_scale = scales.max(1)
    max_min = np.maximum(mins.max(1), 0.0)
    inv_scale = np.where(max_scale > 0,
                         15.0 / np.maximum(max_scale, 1e-30), 0.0)
    inv_min = np.where(max_min > 0, 15.0 / np.maximum(max_min, 1e-30), 0.0)
    ls = np.minimum(_round_half_away_kq(inv_scale[:, None] * scales),
                    15).astype(np.uint8)
    lm = np.minimum(_round_half_away_kq(inv_min[:, None] * mins),
                    15).astype(np.uint8)
    sbytes = (ls | (lm << 4)).astype(np.uint8)              # [nb, 16]
    d = (max_scale / 15.0).astype(np.float16)
    dmin = (max_min / 15.0).astype(np.float16)

    dd = d.astype(np.float32)[:, None] * ls.astype(np.float32)
    dm = dmin.astype(np.float32)[:, None] * lm.astype(np.float32)
    xs = x.reshape(nb, 16, 16)
    with np.errstate(divide="ignore", invalid="ignore"):
        Lq = _round_half_away_kq(
            (xs + dm[..., None]) / np.where(dd == 0, 1.0, dd)[..., None])
    Lq = np.where(dd[..., None] != 0, np.clip(Lq, 0, 3), 0
                  ).reshape(nb, 256).astype(np.uint8)

    qs = np.zeros((nb, 64), np.uint8)
    for half in range(2):
        for j in range(4):
            g = Lq[:, half * 128 + j * 32: half * 128 + (j + 1) * 32]
            qs[:, half * 32:(half + 1) * 32] |= (g << (2 * j)).astype(
                np.uint8)
    out = np.empty((nb, 84), np.uint8)
    out[:, 0:16] = sbytes
    out[:, 16:80] = qs
    out[:, 80:82] = d.view(np.uint8).reshape(nb, 2)
    out[:, 82:84] = dmin.view(np.uint8).reshape(nb, 2)
    return out.reshape(-1)


def _iq4_fit(xb: np.ndarray, wgt: np.ndarray):
    """Fit per-row scale d for the IQ4 nonlinear codebook: anchor at the
    signed extreme over kvalues' extreme (-127), then refine over +-9
    relative perturbations with a weighted-regression update per trial
    (quantize_row_iq4_nl_impl's ntry search, restated). Returns
    (d [M], idx [M, G] codebook indices)."""
    m, g = xb.shape
    pos = xb.argmax(1)
    neg = xb.argmin(1)
    amax = np.maximum(np.abs(xb.max(1)), np.abs(xb.min(1)))
    smax = np.where(np.abs(xb[np.arange(m), neg])
                    >= np.abs(xb[np.arange(m), pos]),
                    xb[np.arange(m), neg], xb[np.arange(m), pos])
    live = amax > 1e-30
    kv = _IQ4NL_KVALUES

    def nearest(vals):
        # kvalues ascending: midpoint thresholds give nearest index
        mids = (kv[1:] + kv[:-1]) / 2.0
        return np.searchsorted(mids, vals).astype(np.int64)

    best_d = np.where(live, smax / kv[0], 0.0)
    best_err = None
    d0 = best_d.copy()
    for t in range(-9, 10):
        d_try = d0 * (1.0 + 0.02 * t)
        with np.errstate(divide="ignore", invalid="ignore"):
            q = nearest(xb / np.where(d_try == 0, 1.0, d_try)[:, None])
        rec = kv[q]
        # refine d by weighted least squares on the chosen codewords
        num = (wgt * xb * rec).sum(1)
        den = (wgt * rec * rec).sum(1)
        d_ref = np.where(den > 0, num / np.maximum(den, 1e-30), d_try)
        err = (wgt * (d_ref[:, None] * rec - xb) ** 2).sum(1)
        if best_err is None:
            best_err, best_d, best_q = err, d_ref, q
        else:
            better = err < best_err
            best_err = np.where(better, err, best_err)
            best_d = np.where(better, d_ref, best_d)
            best_q = np.where(better[:, None], q, best_q)
    best_d = np.where(live, best_d, 0.0)
    return best_d.astype(np.float32), best_q


def quantize_iq4_nl(x: np.ndarray, qw=None) -> np.ndarray:
    """IQ4_NL encoder: 32-wide blocks, fp16 scale, 4-bit indices into the
    kvalues_iq4nl nonlinear codebook. Returns 18 bytes/block."""
    x = np.ascontiguousarray(x, np.float32).reshape(-1, 32)
    wgt = _default_wgt(x, qw)
    d, q = _iq4_fit(x, wgt)
    d16 = d.astype(np.float16)
    # requant against the fp16-rounded scale
    with np.errstate(divide="ignore", invalid="ignore"):
        dv = d16.astype(np.float32)
        mids = (_IQ4NL_KVALUES[1:] + _IQ4NL_KVALUES[:-1]) / 2.0
        q = np.searchsorted(mids, x / np.where(dv == 0, 1.0, dv)[:, None])
        q = np.where(dv[:, None] != 0, q, 8).astype(np.uint8)
    out = np.empty((x.shape[0], 18), np.uint8)
    out[:, :2] = d16.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def quantize_iq4_xs(x: np.ndarray, qw=None) -> np.ndarray:
    """IQ4_XS encoder: 256 superblocks of 8x32 sub-blocks on the IQ4
    codebook, 6-bit offset-32 sub-scales, fp16 d. 136 bytes/block."""
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    assert x.size % 256 == 0, x.size
    nb = x.size // 256
    xb = x.reshape(nb * 8, 32)
    wgt = _default_wgt(xb, qw)
    dsub, _ = _iq4_fit(xb, wgt)
    scales = dsub.reshape(nb, 8)

    amax_sc = np.abs(scales).max(1)
    idx = np.abs(scales).argmax(1)
    smax_sc = scales[np.arange(nb), idx]
    live = amax_sc > 1e-30
    iscale = np.where(live, -32.0 / np.where(live, smax_sc, 1.0), 0.0)
    d = np.where(live, (1.0 / np.where(iscale == 0, 1.0, iscale)
                        ).astype(np.float16), np.float16(0))
    ls = (np.clip(_round_half_away_kq(iscale[:, None] * scales),
                  -32, 31) + 32).astype(np.uint8)           # [nb,8] 0..63

    dl = d.astype(np.float32)[:, None] * (ls.astype(np.float32) - 32.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        mids = (_IQ4NL_KVALUES[1:] + _IQ4NL_KVALUES[:-1]) / 2.0
        ratio = (x.reshape(nb, 8, 32)
                 / np.where(dl == 0, 1.0, dl)[..., None])
        q = np.searchsorted(mids, ratio)
        q = np.where(dl[..., None] != 0, q, 8).astype(np.uint8)

    sl = np.zeros((nb, 4), np.uint8)
    sh = np.zeros((nb,), np.uint16)
    for b in range(8):
        sl[:, b // 2] |= (ls[:, b] & 0xF) << (4 * (b % 2))
        sh |= ((ls[:, b].astype(np.uint16) >> 4) << (2 * b))
    qs = np.zeros((nb, 128), np.uint8)
    for b in range(8):
        qs[:, b * 16:(b + 1) * 16] = (q[:, b, :16] | (q[:, b, 16:] << 4))
    out = np.empty((nb, 136), np.uint8)
    out[:, 0:2] = d.view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = sh.view(np.uint8).reshape(nb, 2)
    out[:, 4:8] = sl
    out[:, 8:136] = qs
    return out.reshape(-1)


def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    """quantize_row_q4_0 semantics: d = signed extreme / -8."""
    x = np.asarray(x, np.float32).reshape(-1, 32)
    idx = np.abs(x).argmax(1)
    smax = x[np.arange(x.shape[0]), idx]
    d = smax / -8.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip((x * inv[:, None] + 8.5).astype(np.int32), 0, 15
                ).astype(np.uint8)
    d16 = d.astype(np.float16)
    out = np.empty((x.shape[0], 18), np.uint8)
    out[:, :2] = d16.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def quantize_q4_1(x: np.ndarray) -> np.ndarray:
    """quantize_row_q4_1 semantics: d = (max-min)/15, m = min."""
    x = np.asarray(x, np.float32).reshape(-1, 32)
    mn = x.min(1)
    mx = x.max(1)
    d = (mx - mn) / 15.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip(((x - mn[:, None]) * inv[:, None] + 0.5).astype(np.int32),
                0, 15).astype(np.uint8)
    d16 = d.astype(np.float16)
    m16 = mn.astype(np.float16)
    out = np.empty((x.shape[0], 20), np.uint8)
    out[:, 0:2] = d16.view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = m16.view(np.uint8).reshape(-1, 2)
    out[:, 4:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def quantize_q5_0(x: np.ndarray) -> np.ndarray:
    """quantize_row_q5_0 semantics: d = signed extreme / -16."""
    x = np.asarray(x, np.float32).reshape(-1, 32)
    idx = np.abs(x).argmax(1)
    smax = x[np.arange(x.shape[0]), idx]
    d = smax / -16.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip((x * inv[:, None] + 16.5).astype(np.int32), 0, 31
                ).astype(np.uint8)
    d16 = d.astype(np.float16)
    qh = np.zeros((x.shape[0],), np.uint32)
    j = np.arange(16, dtype=np.uint32)
    qh |= (((q[:, :16].astype(np.uint32) >> 4) & 1) << j).sum(1,
        dtype=np.uint64).astype(np.uint32)
    qh |= (((q[:, 16:].astype(np.uint32) >> 4) & 1) << (j + 16)).sum(1,
        dtype=np.uint64).astype(np.uint32)
    out = np.empty((x.shape[0], 22), np.uint8)
    out[:, 0:2] = d16.view(np.uint8).reshape(-1, 2)
    out[:, 2:6] = qh.view(np.uint8).reshape(-1, 4)
    out[:, 6:] = (q[:, :16] & 0xF) | ((q[:, 16:] & 0xF) << 4)
    return out.reshape(-1)


def quantize_q5_1(x: np.ndarray) -> np.ndarray:
    """quantize_row_q5_1 semantics: d = (max-min)/31, m = min."""
    x = np.asarray(x, np.float32).reshape(-1, 32)
    mn = x.min(1)
    mx = x.max(1)
    d = (mx - mn) / 31.0
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    q = np.clip(((x - mn[:, None]) * inv[:, None] + 0.5).astype(np.int32),
                0, 31).astype(np.uint8)
    qh = np.zeros((x.shape[0],), np.uint32)
    j = np.arange(16, dtype=np.uint32)
    qh |= (((q[:, :16].astype(np.uint32) >> 4) & 1) << j).sum(1,
        dtype=np.uint64).astype(np.uint32)
    qh |= (((q[:, 16:].astype(np.uint32) >> 4) & 1) << (j + 16)).sum(1,
        dtype=np.uint64).astype(np.uint32)
    out = np.empty((x.shape[0], 24), np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = mn.astype(np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 4:8] = qh.view(np.uint8).reshape(-1, 4)
    out[:, 8:] = (q[:, :16] & 0xF) | ((q[:, 16:] & 0xF) << 4)
    return out.reshape(-1)


def dequantize_q6_k(raw: np.ndarray, n: int) -> np.ndarray:
    # block: ql[128], qh[64], scales[16] int8, fp16 d (dequantize_row_q6_K)
    blocks = raw.reshape(-1, 210)
    ql = blocks[:, 0:128]
    qh = blocks[:, 128:192]
    sc = blocks[:, 192:208].view(np.int8).astype(np.float32)
    d = _fp16(blocks[:, 208:210].copy())[:, 0]
    nb = blocks.shape[0]
    out = np.empty((nb, 256), np.float32)
    for half in range(2):  # n in {0, 128}
        qlh = ql[:, half * 64 : half * 64 + 64]
        qhh = qh[:, half * 32 : half * 32 + 32]
        sch = sc[:, half * 8 : half * 8 + 8]
        l = np.arange(32)
        is_ = l // 16                                        # [32]
        q1 = ((qlh[:, :32] & 0xF) | (((qhh >> 0) & 3) << 4)).astype(np.int8) - 32
        q2 = ((qlh[:, 32:] & 0xF) | (((qhh >> 2) & 3) << 4)).astype(np.int8) - 32
        q3 = ((qlh[:, :32] >> 4) | (((qhh >> 4) & 3) << 4)).astype(np.int8) - 32
        q4 = ((qlh[:, 32:] >> 4) | (((qhh >> 6) & 3) << 4)).astype(np.int8) - 32
        base = half * 128
        out[:, base + 0 : base + 32] = d[:, None] * sch[:, is_ + 0] * q1
        out[:, base + 32 : base + 64] = d[:, None] * sch[:, is_ + 2] * q2
        out[:, base + 64 : base + 96] = d[:, None] * sch[:, is_ + 4] * q3
        out[:, base + 96 : base + 128] = d[:, None] * sch[:, is_ + 6] * q4
    return out.reshape(-1)[:n]


def dequantize_q5_k(raw: np.ndarray, n: int) -> np.ndarray:
    # block: fp16 d, fp16 dmin, scales[12], qh[32], qs[128]
    blocks = raw.reshape(-1, 176)
    d = _fp16(blocks[:, 0:2].copy())[:, 0]
    dmin = _fp16(blocks[:, 2:4].copy())[:, 0]
    sc, mn = _q4k_scale_min(blocks[:, 4:16])
    qh = blocks[:, 16:48]
    qs = blocks[:, 48:176]
    nb = blocks.shape[0]
    out = np.empty((nb, 256), np.float32)
    u = 1
    for c in range(4):
        q = qs[:, c * 32 : (c + 1) * 32]
        lo = (q & 0xF).astype(np.float32) + np.where((qh & u) != 0, 16.0, 0.0)
        u <<= 1
        hi = (q >> 4).astype(np.float32) + np.where((qh & u) != 0, 16.0, 0.0)
        u <<= 1
        out[:, c * 64 : c * 64 + 32] = d[:, None] * sc[:, 2 * c, None] * lo - dmin[:, None] * mn[:, 2 * c, None]
        out[:, c * 64 + 32 : c * 64 + 64] = d[:, None] * sc[:, 2 * c + 1, None] * hi - dmin[:, None] * mn[:, 2 * c + 1, None]
    return out.reshape(-1)[:n]


def dequantize_q4_1(raw: np.ndarray, n: int) -> np.ndarray:
    # block: fp16 d, fp16 m, 16B nibbles; x = d*q + m (dequantize_row_q4_1)
    blocks = raw.reshape(-1, 20)
    d = _fp16(blocks[:, 0:2].copy())
    m = _fp16(blocks[:, 2:4].copy())
    qs = blocks[:, 4:]
    q = np.concatenate([(qs & 0xF), (qs >> 4)], axis=1).astype(np.float32)
    return (q * d + m).reshape(-1)[:n]


def _q5_bits(blocks: np.ndarray, off: int) -> np.ndarray:
    """Assemble the 32 5-bit quants of a q5_0/q5_1 block: low/high nibble
    of qs[j] plus bit j / j+16 of the uint32 qh (dequantize_row_q5_0)."""
    qh = blocks[:, off:off + 4].copy().view(np.uint32)      # [nb, 1]
    qs = blocks[:, off + 4:]
    j = np.arange(16, dtype=np.uint32)
    lo = (qs & 0xF).astype(np.int32) | (((qh >> j) & 1) << 4).astype(np.int32)
    hi = (qs >> 4).astype(np.int32) | (((qh >> (j + 16)) & 1) << 4).astype(np.int32)
    return np.concatenate([lo, hi], axis=1).astype(np.float32)


def dequantize_q5_0(raw: np.ndarray, n: int) -> np.ndarray:
    # block: fp16 d, uint32 qh, 16B qs; x = d*(q5 - 16)
    blocks = raw.reshape(-1, 22)
    d = _fp16(blocks[:, 0:2].copy())
    return ((_q5_bits(blocks, 2) - 16.0) * d).reshape(-1)[:n]


def dequantize_q5_1(raw: np.ndarray, n: int) -> np.ndarray:
    # block: fp16 d, fp16 m, uint32 qh, 16B qs; x = d*q5 + m
    blocks = raw.reshape(-1, 24)
    d = _fp16(blocks[:, 0:2].copy())
    m = _fp16(blocks[:, 2:4].copy())
    return (_q5_bits(blocks, 4) * d + m).reshape(-1)[:n]


def dequantize_q2_k(raw: np.ndarray, n: int) -> np.ndarray:
    # block: scales[16] (lo-nibble scale, hi-nibble min), qs[64] 2-bit,
    # fp16 d, fp16 dmin (dequantize_row_q2_K); x = d*sc*q - dmin*mn per
    # 16-elem group, two scale bytes per 32-elem shift group.
    blocks = raw.reshape(-1, 84)
    scales = blocks[:, :16]
    qs = blocks[:, 16:80]
    d = _fp16(blocks[:, 80:82].copy())[:, 0]
    dmin = _fp16(blocks[:, 82:84].copy())[:, 0]
    nb = blocks.shape[0]
    out = np.empty((nb, 256), np.float32)
    isc = 0
    for half in range(2):                       # n in {0, 128}: 32 bytes each
        q = qs[:, half * 32:(half + 1) * 32]
        for j in range(4):                      # shifts 0,2,4,6
            g = ((q >> (2 * j)) & 3).astype(np.float32)          # [nb, 32]
            for part in range(2):               # l<16 / l>=16
                sc = scales[:, isc]
                isc += 1
                dl = d * (sc & 0xF).astype(np.float32)
                ml = dmin * (sc >> 4).astype(np.float32)
                base = half * 128 + j * 32 + part * 16
                out[:, base:base + 16] = (
                    dl[:, None] * g[:, part * 16:part * 16 + 16] - ml[:, None])
    return out.reshape(-1)[:n]


def dequantize_q3_k(raw: np.ndarray, n: int) -> np.ndarray:
    # block: hmask[32], qs[64] 2-bit, scales[12] (16 packed 6-bit), fp16 d
    # (dequantize_row_q3_K); q = 2-bit - (hmask bit ? 0 : 4), x = d*(sc-32)*q
    blocks = raw.reshape(-1, 110)
    hmask = blocks[:, :32]
    qs = blocks[:, 32:96]
    scb = blocks[:, 96:108].copy().view(np.uint32)           # [nb, 3]
    d = _fp16(blocks[:, 108:110].copy())[:, 0]
    nb = blocks.shape[0]
    # unpack 12 bytes -> 16 6-bit scales (the kmask shuffle, ggml-quants.c)
    k1, k2 = np.uint32(0x03030303), np.uint32(0x0F0F0F0F)
    tmp = scb[:, 2]
    aux = np.empty((nb, 4), np.uint32)
    aux[:, 0] = (scb[:, 0] & k2) | (((tmp >> 0) & k1) << 4)
    aux[:, 1] = (scb[:, 1] & k2) | (((tmp >> 2) & k1) << 4)
    aux[:, 2] = ((scb[:, 0] >> 4) & k2) | (((tmp >> 4) & k1) << 4)
    aux[:, 3] = ((scb[:, 1] >> 4) & k2) | (((tmp >> 6) & k1) << 4)
    scales = aux.view(np.uint8).reshape(nb, 16).astype(np.float32) - 32.0
    out = np.empty((nb, 256), np.float32)
    m = 1
    isc = 0
    for half in range(2):
        q = qs[:, half * 32:(half + 1) * 32]
        for j in range(4):
            g = ((q >> (2 * j)) & 3).astype(np.float32)
            g -= np.where((hmask & m) != 0, 0.0, 4.0)
            for part in range(2):
                dl = d * scales[:, isc]
                isc += 1
                base = half * 128 + j * 32 + part * 16
                out[:, base:base + 16] = (
                    dl[:, None] * g[:, part * 16:part * 16 + 16])
            m <<= 1
    return out.reshape(-1)[:n]


def dequantize_q8_k(raw: np.ndarray, n: int) -> np.ndarray:
    # block: f32 d, int8 qs[256], int16 bsums[16] (dequantize_row_q8_K)
    blocks = raw.reshape(-1, 292)
    d = blocks[:, :4].copy().view(np.float32)
    q = blocks[:, 4:260].view(np.int8).astype(np.float32)
    return (q * d).reshape(-1)[:n]


# kvalues_iq4nl (ggml-common.h): the 16-entry non-linear 4-bit codebook —
# format spec data, required for bit-exact GGUF interop.
_IQ4NL_KVALUES = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10,
     1, 13, 25, 38, 53, 69, 89, 113], np.float32)


def dequantize_iq4_nl(raw: np.ndarray, n: int) -> np.ndarray:
    # block: fp16 d + 16B qs per 32 elems; x = d * kvalues[nibble]
    blocks = raw.reshape(-1, 18)
    d = _fp16(blocks[:, 0:2].copy())
    qs = blocks[:, 2:]
    idx = np.concatenate([(qs & 0xF), (qs >> 4)], axis=1)
    return (_IQ4NL_KVALUES[idx] * d).reshape(-1)[:n]


def dequantize_iq4_xs(raw: np.ndarray, n: int) -> np.ndarray:
    # block: fp16 d, uint16 scales_h, scales_l[4], qs[128]
    # (dequantize_row_iq4_xs); 8 sub-blocks of 32, 6-bit scale - 32
    blocks = raw.reshape(-1, 136)
    d = _fp16(blocks[:, 0:2].copy())[:, 0]
    sh = blocks[:, 2:4].copy().view(np.uint16).astype(np.uint32)[:, 0]
    sl = blocks[:, 4:8]
    qs = blocks[:, 8:136]
    nb = blocks.shape[0]
    ib = np.arange(8)
    ls = (((sl[:, ib // 2] >> (4 * (ib % 2))) & 0xF).astype(np.uint32)
          | (((sh[:, None] >> (2 * ib)) & 3) << 4))
    dl = d[:, None] * (ls.astype(np.float32) - 32.0)         # [nb, 8]
    out = np.empty((nb, 256), np.float32)
    for b in range(8):
        q = qs[:, b * 16:(b + 1) * 16]
        out[:, b * 32:b * 32 + 16] = dl[:, b, None] * _IQ4NL_KVALUES[q & 0xF]
        out[:, b * 32 + 16:b * 32 + 32] = dl[:, b, None] * _IQ4NL_KVALUES[q >> 4]
    return out.reshape(-1)[:n]


# --- i-quants (codebook lattice formats, ggml-quants.c dequantize_row_iq*) ---
# Codebook spec data lives in formats/iq_grids.py; the sign convention is
# shared: ksigns[i] bit j set -> negate element j of the 8-wide group.


def _sign_pm1(sign_bytes: np.ndarray) -> np.ndarray:
    """[..., g] uint8 -> [..., g, 8] of +-1.0 from per-bit sign flags."""
    bits = (sign_bytes[..., None] >> np.arange(8, dtype=np.uint8)) & 1
    return 1.0 - 2.0 * bits.astype(np.float32)


def dequantize_iq2_xxs(raw: np.ndarray, n: int) -> np.ndarray:
    # block 66B: fp16 d + 16 uint32 pairs; pair = (4 grid bytes, aux32 with
    # 4x7-bit sign selectors + 4-bit scale in the top nibble)
    from rrs_tpu_torch.formats.iq_grids import IQ2XXS_GRID, KSIGNS

    blocks = raw.reshape(-1, 66)
    nb = blocks.shape[0]
    d = _fp16(blocks[:, 0:2].copy())[:, 0]
    q32 = blocks[:, 2:].copy().view(np.uint32).reshape(nb, 8, 2)
    gidx = q32[:, :, 0:1].view(np.uint8).reshape(nb, 8, 4)       # grid rows
    aux = q32[:, :, 1]
    db = d[:, None] * (0.5 + (aux >> 28).astype(np.float32)) * 0.25
    sel = (aux[:, :, None] >> np.array([0, 7, 14, 21], np.uint32)) & 0x7F
    signs = _sign_pm1(KSIGNS[sel])                               # [nb,8,4,8]
    vals = IQ2XXS_GRID[gidx]                                     # [nb,8,4,8]
    return (db[:, :, None, None] * vals * signs).reshape(-1)[:n]


def dequantize_iq2_xs(raw: np.ndarray, n: int) -> np.ndarray:
    # block 74B: fp16 d, 32 uint16 (9-bit grid row | 7-bit sign selector),
    # 8 scale bytes (two nibbles each, one per 16 elems)
    from rrs_tpu_torch.formats.iq_grids import IQ2XS_GRID, KSIGNS

    blocks = raw.reshape(-1, 74)
    nb = blocks.shape[0]
    d = _fp16(blocks[:, 0:2].copy())[:, 0]
    q16 = blocks[:, 2:66].copy().view(np.uint16)                 # [nb, 32]
    sc = blocks[:, 66:74]
    nib = np.stack([sc & 0xF, sc >> 4], axis=2).reshape(nb, 16)
    db = d[:, None] * (0.5 + nib.astype(np.float32)) * 0.25      # per 2 words
    signs = _sign_pm1(KSIGNS[q16 >> 9])                          # [nb,32,8]
    vals = IQ2XS_GRID[q16 & 511]                                 # [nb,32,8]
    out = np.repeat(db, 2, axis=1)[:, :, None] * vals * signs
    return out.reshape(-1)[:n]


def dequantize_iq2_s(raw: np.ndarray, n: int) -> np.ndarray:
    # block 82B: fp16 d, qs[32] (grid low bytes), signs[32] (raw bit flags),
    # qh[8] (2 high bits per qs byte), scales[8] nibbles
    from rrs_tpu_torch.formats.iq_grids import IQ2S_GRID

    blocks = raw.reshape(-1, 82)
    nb = blocks.shape[0]
    d = _fp16(blocks[:, 0:2].copy())[:, 0]
    qs = blocks[:, 2:34]
    sgn = blocks[:, 34:66]
    qh = blocks[:, 66:74]
    sc = blocks[:, 74:82]
    nib = np.stack([sc & 0xF, sc >> 4], axis=2).reshape(nb, 16)
    db = d[:, None] * (0.5 + nib.astype(np.float32)) * 0.25
    hi = (qh[:, :, None] >> np.array([0, 2, 4, 6], np.uint8)) & 3
    gidx = qs.astype(np.uint16) | (hi.reshape(nb, 32).astype(np.uint16) << 8)
    signs = _sign_pm1(sgn)                                       # [nb,32,8]
    vals = IQ2S_GRID[gidx]                                       # [nb,32,8]
    out = np.repeat(db, 2, axis=1)[:, :, None] * vals * signs
    return out.reshape(-1)[:n]


def dequantize_iq3_xxs(raw: np.ndarray, n: int) -> np.ndarray:
    # block 98B: fp16 d, qs[64] (grid rows of 4), 8 aux32 (signs + scale)
    from rrs_tpu_torch.formats.iq_grids import IQ3XXS_GRID, KSIGNS

    blocks = raw.reshape(-1, 98)
    nb = blocks.shape[0]
    d = _fp16(blocks[:, 0:2].copy())[:, 0]
    qs = blocks[:, 2:66].reshape(nb, 8, 8)                       # 8 rows/group
    aux = blocks[:, 66:98].copy().view(np.uint32)                # [nb, 8]
    db = d[:, None] * (0.5 + (aux >> 28).astype(np.float32)) * 0.5
    sel = (aux[:, :, None] >> np.array([0, 7, 14, 21], np.uint32)) & 0x7F
    signs = _sign_pm1(KSIGNS[sel])                               # [nb,8,4,8]
    vals = IQ3XXS_GRID[qs].reshape(nb, 8, 4, 8)                  # 2 rows/sign
    return (db[:, :, None, None] * vals * signs).reshape(-1)[:n]


def dequantize_iq3_s(raw: np.ndarray, n: int) -> np.ndarray:
    # block 110B: fp16 d, qs[64], qh[8] (1 high bit per qs byte),
    # signs[32] raw flags, scales[4] nibbles (per 32 elems)
    from rrs_tpu_torch.formats.iq_grids import IQ3S_GRID

    blocks = raw.reshape(-1, 110)
    nb = blocks.shape[0]
    d = _fp16(blocks[:, 0:2].copy())[:, 0]
    qs = blocks[:, 2:66]
    qh = blocks[:, 66:74]
    sgn = blocks[:, 74:106]
    sc = blocks[:, 106:110]
    nib = np.stack([sc & 0xF, sc >> 4], axis=2).reshape(nb, 8)
    db = d[:, None] * (1.0 + 2.0 * nib.astype(np.float32))       # per 32 elems
    hi = ((qh[:, :, None] >> np.arange(8, dtype=np.uint8)) & 1).reshape(nb, 64)
    gidx = qs.astype(np.uint16) | (hi.astype(np.uint16) << 8)
    signs = _sign_pm1(sgn).reshape(nb, 8, 32)
    vals = IQ3S_GRID[gidx].reshape(nb, 8, 32)
    return (db[:, :, None] * vals * signs).reshape(-1)[:n]


def dequantize_iq1_s(raw: np.ndarray, n: int) -> np.ndarray:
    # block 50B: fp16 d, qs[32] grid low bytes, 8 uint16 qh: 3-bit highs at
    # [0,3,6,9], 3-bit scale at 12, delta sign at 15; x = dl*(grid +- 0.125)
    from rrs_tpu_torch.formats.iq_grids import IQ1S_GRID

    blocks = raw.reshape(-1, 50)
    nb = blocks.shape[0]
    d = _fp16(blocks[:, 0:2].copy())[:, 0]
    qs = blocks[:, 2:34]
    qh = blocks[:, 34:50].copy().view(np.uint16)                 # [nb, 8]
    dl = d[:, None] * (2.0 * ((qh >> 12) & 7).astype(np.float32) + 1.0)
    delta = np.where((qh & 0x8000) == 0, np.float32(0.125), np.float32(-0.125))
    hi = (qh[:, :, None] >> np.array([0, 3, 6, 9], np.uint16)) & 7
    gidx = qs.astype(np.uint16) | (hi.reshape(nb, 32) << 8)
    vals = IQ1S_GRID[gidx].reshape(nb, 8, 4, 8)
    out = dl[:, :, None, None] * (vals + delta[:, :, None, None])
    return out.reshape(-1)[:n]


def dequantize_iq1_m(raw: np.ndarray, n: int) -> np.ndarray:
    # block 56B: qs[32], qh[16] (nibble: 3 high bits + delta flag), 4 uint16
    # whose top nibbles reassemble the fp16 d; 3-bit scales at [0,3,6,9]
    from rrs_tpu_torch.formats.iq_grids import IQ1S_GRID

    blocks = raw.reshape(-1, 56)
    nb = blocks.shape[0]
    qs = blocks[:, 0:32]
    qh = blocks[:, 32:48]
    sw = blocks[:, 48:56].copy().view(np.uint16)                 # [nb, 4]
    dbits = ((sw & 0xF000) >> np.array([12, 8, 4, 0], np.uint16))
    d = (dbits[:, 0] | dbits[:, 1] | dbits[:, 2] | dbits[:, 3]) \
        .astype(np.uint16).reshape(nb, 1).view(np.uint8) \
        .copy().view(np.float16).astype(np.float32)[:, 0]
    sc3 = ((sw[:, :, None] >> np.array([0, 3, 6, 9], np.uint16)) & 7) \
        .reshape(nb, 16).astype(np.float32)
    dl = d[:, None] * (2.0 * sc3 + 1.0)                          # per 16 elems
    nib = np.stack([qh & 0xF, qh >> 4], axis=2).reshape(nb, 32)
    gidx = qs.astype(np.uint16) | ((nib & 7).astype(np.uint16) << 8)
    delta = np.where((nib & 0x8) == 0, np.float32(0.125), np.float32(-0.125))
    vals = (IQ1S_GRID[gidx] + delta[:, :, None]).reshape(nb, 16, 16)
    return (dl[:, :, None] * vals).reshape(-1)[:n]


_POW3 = np.array([1, 3, 9, 27, 81], np.uint8)


def dequantize_tq1_0(raw: np.ndarray, n: int) -> np.ndarray:
    """TQ1_0 ternary (BitNet b1.58): 48B of base-243 packed trits (5/byte),
    4B of 4-trit bytes, fp16 d (dequantize_row_tq1_0, ggml-quants.c).
    Trit k of packed byte b is extracted with the canonical fixed-point
    trick: (uint8)(b * 3^k) * 3 >> 8, then shifted to {-1,0,1}."""
    blocks = raw.reshape(-1, 54)
    nb = blocks.shape[0]
    d = _fp16(blocks[:, 52:54].copy())[:, 0]
    out = np.empty((nb, 256), np.float32)

    def trits(packed, k_count):
        # packed: [nb, m] uint8 -> [nb, k_count, m] trit values in {-1,0,1}
        p = packed[:, None, :] * _POW3[:k_count, None]        # uint8 wraps
        return ((p.astype(np.uint16) * 3) >> 8).astype(np.int8) - 1

    # elements 0..159: 32-byte chunk c covers [c*160 + k*32 + j]
    q0 = blocks[:, :32]
    out[:, :160] = trits(q0, 5).reshape(nb, 160)
    # elements 160..239: 16-byte chunk, same 5-trit packing
    q1 = blocks[:, 32:48]
    out[:, 160:240] = trits(q1, 5).reshape(nb, 80)
    # elements 240..255: qh, 4 trits per byte
    qh = blocks[:, 48:52]
    out[:, 240:256] = trits(qh, 4).reshape(nb, 16)
    return (out * d[:, None]).reshape(-1)[:n]


def quantize_tq1_0(x: np.ndarray) -> np.ndarray:
    """quantize_row_tq1_0: d = absmax, trits = round(x/d) in {-1,0,1},
    packed 5 (or 4 for qh) per byte as ceil(v * 256/243)."""
    x = np.asarray(x, np.float32).reshape(-1, 256)
    nb = x.shape[0]
    d = np.abs(x).max(axis=1)
    inv = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    t = (_round_half_away_kq(x * inv[:, None]).astype(np.int8) + 1).astype(np.uint8)

    def pack(tr, k_count):
        # tr: [nb, k_count, m] -> [nb, m] bytes; trit k carries weight
        # 3^(4-k) (the 4-trit qh bytes have no units digit)
        w = _POW3[::-1][:k_count].copy()
        v = (tr * w[None, :, None]).sum(axis=1).astype(np.uint16)
        return ((v * 256 + 242) // 243).astype(np.uint8)

    qs0 = pack(t[:, :160].reshape(nb, 5, 32), 5)
    qs1 = pack(t[:, 160:240].reshape(nb, 5, 16), 5)
    qh = pack(t[:, 240:256].reshape(nb, 4, 4), 4)
    d16 = d.astype(np.float16)[:, None].view(np.uint8).reshape(nb, 2)
    return np.concatenate([qs0, qs1, qh, d16], axis=1).reshape(-1)


def dequantize_tq2_0(raw: np.ndarray, n: int) -> np.ndarray:
    # 64B of 2-bit codes (chunk c of 32 bytes -> elems c*128 + k*32 + j,
    # shift 2k), fp16 d; x = d * (code - 1)
    blocks = raw.reshape(-1, 66)
    nb = blocks.shape[0]
    d = _fp16(blocks[:, 64:66].copy())[:, 0]
    qs = blocks[:, :64].reshape(nb, 2, 32)
    shifts = np.array([0, 2, 4, 6], np.uint8)
    g = ((qs[:, :, None, :] >> shifts[None, None, :, None]) & 3).astype(np.int8) - 1
    return (g.reshape(nb, 256) * d[:, None, ]).reshape(-1)[:n]


def quantize_tq2_0(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32).reshape(-1, 256)
    nb = x.shape[0]
    d = np.abs(x).max(axis=1)
    inv = np.where(d > 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
    t = (_round_half_away_kq(x * inv[:, None]).astype(np.int8) + 1).astype(np.uint8)
    tr = t.reshape(nb, 2, 4, 32)
    shifts = np.array([0, 2, 4, 6], np.uint8)
    qs = (tr << shifts[None, None, :, None]).astype(np.uint8)
    qs = (qs[:, :, 0] | qs[:, :, 1] | qs[:, :, 2] | qs[:, :, 3]).reshape(nb, 64)
    d16 = d.astype(np.float16)[:, None].view(np.uint8).reshape(nb, 2)
    return np.concatenate([qs, d16], axis=1).reshape(-1)


_DEQUANT = {
    GGMLType.Q8_0: dequantize_q8_0,
    GGMLType.Q4_0: dequantize_q4_0,
    GGMLType.Q4_1: dequantize_q4_1,
    GGMLType.Q5_0: dequantize_q5_0,
    GGMLType.Q5_1: dequantize_q5_1,
    GGMLType.Q2_K: dequantize_q2_k,
    GGMLType.Q3_K: dequantize_q3_k,
    GGMLType.Q4_K: dequantize_q4_k,
    GGMLType.Q5_K: dequantize_q5_k,
    GGMLType.Q6_K: dequantize_q6_k,
    GGMLType.Q8_K: dequantize_q8_k,
    GGMLType.IQ4_NL: dequantize_iq4_nl,
    GGMLType.IQ4_XS: dequantize_iq4_xs,
    GGMLType.TQ1_0: dequantize_tq1_0,
    GGMLType.TQ2_0: dequantize_tq2_0,
    GGMLType.IQ2_XXS: dequantize_iq2_xxs,
    GGMLType.IQ2_XS: dequantize_iq2_xs,
    GGMLType.IQ2_S: dequantize_iq2_s,
    GGMLType.IQ3_XXS: dequantize_iq3_xxs,
    GGMLType.IQ3_S: dequantize_iq3_s,
    GGMLType.IQ1_S: dequantize_iq1_s,
    GGMLType.IQ1_M: dequantize_iq1_m,
    GGMLType.MXFP4: lambda raw, n: dequantize_mxfp4(raw, n),
}


_NATIVE_KIND = {
    GGMLType.Q8_0: "q8_0",
    GGMLType.Q4_K: "q4_k",
    GGMLType.Q6_K: "q6_k",
}


def dequantize(raw: np.ndarray, ggml_type: GGMLType, shape: tuple[int, ...]) -> np.ndarray:
    """Dequantize a raw GGUF tensor payload to f32 in its logical shape."""
    if ggml_type == GGMLType.TCQ4_K32:
        from rrs_tpu_torch.formats.tile_codec import decode_tcq4_gguf
        from rrs_tpu_torch.formats.tcq4 import dequantize_tcq4

        if len(shape) == 3:       # stacked MoE experts: per-expert payloads
            per = raw.size // shape[0]
            return np.stack([
                dequantize_tcq4(
                    decode_tcq4_gguf(raw[e * per:(e + 1) * per], shape[1:]),
                    rotated=False).T.reshape(shape[1:])
                for e in range(shape[0])])
        t = decode_tcq4_gguf(raw, shape)
        return dequantize_tcq4(t, rotated=False).T.reshape(shape)
    n = 1
    for s in shape:
        n *= s
    kind = _NATIVE_KIND.get(ggml_type)
    if kind is not None:
        from rrs_tpu_torch import native

        if native.available():
            return native.dequant(raw, kind, n).reshape(shape)
    fn = _DEQUANT.get(ggml_type)
    if fn is None:
        raise NotImplementedError(f"no dequantizer for {ggml_type!r}")
    return fn(raw, n).reshape(shape)


_MXFP4_KVALUES = np.array(
    [0, 1, 2, 3, 4, 6, 8, 12, 0, -1, -2, -3, -4, -6, -8, -12], np.int8)


def dequantize_mxfp4(raw: np.ndarray, n: int) -> np.ndarray:
    """MXFP4 (block_mxfp4: uint8 E8M0 scale + 16 B of e2m1 nibbles per 32
    elems; dequantize_row_mxfp4, ggml-quants.c:421-439). Scale is
    e8m0_to_fp32_half (the fp4 values are doubled)."""
    blocks = np.frombuffer(np.ascontiguousarray(raw).tobytes(),
                           np.uint8).reshape(-1, 17)
    e = blocks[:, 0].astype(np.int64)
    # e8m0_to_fp32_half: 2^(e-128) for e>=2; denormal patterns for e<2
    bits = np.where(e < 2, np.uint32(0x00200000) << e,
                    (e - 1).astype(np.uint32) << 23).astype(np.uint32)
    d = bits.view(np.float32)
    qs = blocks[:, 1:]
    lo = _MXFP4_KVALUES[qs & 0x0F].astype(np.float32)
    hi = _MXFP4_KVALUES[qs >> 4].astype(np.float32)
    out = np.concatenate([lo, hi], axis=1) * d[:, None]
    return out.reshape(-1)[:n]


def quantize_mxfp4(x: np.ndarray) -> np.ndarray:
    """Inverse codec (round-to-nearest against the e2m1 value table with a
    per-32-block power-of-two shared scale, quantize_row_mxfp4 semantics)."""
    x = np.asarray(x, np.float32).reshape(-1, 32)
    nb = x.shape[0]
    amax = np.abs(x).max(axis=1)
    # smallest power-of-two d with amax <= 12*d (the table's max magnitude):
    # e8m0_half gives d = 2^(e-128), so e = 128 + ceil(log2(amax/12))
    with np.errstate(divide="ignore"):
        e = np.ceil(np.log2(np.maximum(amax, 1e-38) / 12.0)).astype(np.int64) + 128
    e = np.clip(e, 1, 254).astype(np.uint8)
    bits = np.where(e < 2, np.uint32(0x00200000) << e.astype(np.int64),
                    (e.astype(np.int64) - 1).astype(np.uint32) << 23).astype(np.uint32)
    d = bits.view(np.float32)
    vals = _MXFP4_KVALUES.astype(np.float32)
    scaled = x / np.maximum(d, 1e-38)[:, None]
    idx = np.abs(scaled[:, :, None] - vals[None, None, :]).argmin(axis=2)
    lo = idx[:, :16].astype(np.uint8)
    hi = idx[:, 16:].astype(np.uint8)
    out = np.empty((nb, 17), np.uint8)
    out[:, 0] = e
    out[:, 1:] = lo | (hi << 4)
    return out.reshape(-1)
