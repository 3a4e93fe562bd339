"""MXFP4 weight matmuls (gpt-oss's expert format): kernels B11-B13 and their
plain versions.

Port of ``rrs_tpu/ops/mxfp4_matmul.py``. The packed 4.25-bit payload stays in
device memory and every kernel decodes it on chip, so no dequantized expert
ever reaches device memory (at gpt-oss-20b that copy would be about twice the
weight bytes). Device layout, as the JAX package packs it:

  qs   uint8 [K//2, N]   byte row j holds the e2m1 codes of the ADJACENT
                         elements k = 2j (low nibble) and 2j + 1 (high), so
                         both nibbles of a byte share one 32-wide scale group;
  sexp uint8 [K//32, N]  the f32 exponent field of the half block scale
                         (e8m0 byte - 1, clamped to [1, 251]).

Codes are remapped at pack time (magnitude codes 0 and 1 swapped), so code 1
is zero and every other code decodes with one formula: the f32 bits
``(em << 22) + (sexp << 23)`` with ``em = code & 7``, and the sign in bit 31.
Every decoded value is exact in bf16, so the kernels and their plain versions
(bf16(a) @ the decoded weights, f32 accumulation, as the TPU kernels compute)
differ only in the order of their sums.

Each wrapper takes its plain version only for CPU tensors; for CUDA tensors
it launches its kernel (``csrc/mxfp4_matmul.cu``) or raises:

  B11 ``mxfp4_matmul``               a [M, K] @ W [K, N], on the two bodies of
                                     ``csrc/gemm_sm90.cuh`` with K split by
                                     ``splitk_plan`` (whole scale groups)
  B12 ``mxfp4_matmul_experts_rows``  out[i] = a[i] @ W[ids[i]]   (decode), on
                                     the decode body of ``csrc/gemm_sm90.cuh``
                                     with the rows on the grid, K split by
                                     ``rows_plan``
  B13 ``mxfp4_matmul_all_experts``   out[e] = a (or a[e]) @ W[e], on the
                                     prefill body of ``csrc/gemm_sm90.cuh``
                                     over ``splitk.experts_grid``
"""

from __future__ import annotations

import numpy as np
import torch

from rrs_tpu_torch import kernels
from rrs_tpu_torch.ops import splitk

GROUP = 32          # elements per MXFP4 scale block
SUPER = 64          # elements per K tile of the kernels (two scale groups)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# ---------------------------------------------------------------------------
# Host-side repack: GGUF MXFP4 payload -> device (qs, sexp)
# ---------------------------------------------------------------------------

def pack_mxfp4_device(raw: np.ndarray, shape, pad_n: int = 128):
    """GGUF MXFP4 payload for a logical [N, K] weight -> (qs [K//2, Npad]
    uint8, sexp [K//32, Npad] uint8): the 0 <-> 1 code remap, adjacent-pair
    nibbles, sexp = e8m0 byte - 1 clamped to [1, 251], and N padded to a
    multiple of ``pad_n`` with zero codes (0x11 bytes)."""
    n, k = shape
    if k % SUPER:
        raise ValueError(f"MXFP4 device layout needs K % {SUPER} == 0, got {k}")
    blocks = np.frombuffer(np.ascontiguousarray(raw).tobytes(),
                           np.uint8).reshape(n, k // GROUP, 17)
    sexp = np.clip(blocks[:, :, 0], 2, 252) - 1      # [N, K//32]
    b = blocks[:, :, 1:]                             # [N, K//32, 16]
    codes = np.concatenate([b & 15, b >> 4], axis=2).reshape(n, k)
    codes = np.where((codes & 7) < 2, codes ^ 1, codes)
    ck = codes.T.reshape(k // 2, 2, n)               # [K//2, even/odd, N]
    qs = (ck[:, 0] | (ck[:, 1] << 4)).astype(np.uint8)
    sexp = np.ascontiguousarray(sexp.T)              # [K//32, N]
    n_pad = _round_up(n, pad_n)
    if n_pad != n:
        qs = np.pad(qs, ((0, 0), (0, n_pad - n)), constant_values=0x11)
        sexp = np.pad(sexp, ((0, 0), (0, n_pad - n)))
    return np.ascontiguousarray(qs), sexp


# ---------------------------------------------------------------------------
# Decode and plain versions
# ---------------------------------------------------------------------------

_SIGN = -(1 << 31)


def _fp4_bits(u: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """int32 remapped codes u + exponent bits t (sexp << 23) -> the f32 bit
    pattern of kvalue * 2^(sexp - 127)."""
    em = u & 7
    bits = torch.where(em == 1, torch.zeros_like(em), (em << 22) + t)
    return torch.where((u & 8) != 0, bits | _SIGN, bits)


def dequant_mxfp4(qs: torch.Tensor, sexp: torch.Tensor) -> torch.Tensor:
    """[..., K//2, N] uint8 + sexp [..., K//32, N] -> [..., K, N] f32, the
    f32 twin of the JAX package's ``dequant_mxfp4_jnp`` (bit-equal)."""
    *lead, k2, n = qs.shape
    q = qs.to(torch.int32).reshape(*lead, k2 // 16, 16, n)
    t = (sexp.to(torch.int32) << 23).reshape(*lead, k2 // 16, 1, n)
    lo = _fp4_bits(q & 15, t)
    hi = _fp4_bits((q >> 4) & 15, t)
    out = torch.stack([lo, hi], dim=-2)              # [..., G, 16, 2, N]
    return out.reshape(*lead, k2 * 2, n).view(torch.float32)


def _bf16_f32(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).to(torch.float32)


def mxfp4_matmul_ref(a, qs, sexp) -> torch.Tensor:
    """f32 oracle (rrs_tpu/ops/mxfp4_matmul.py:336): a in f32."""
    return a.to(torch.float32) @ dequant_mxfp4(qs, sexp)


def mxfp4_matmul_plain(a, qs, sexp) -> torch.Tensor:
    """B11's plain version: bf16(a) @ W with f32 accumulation; f32 [M, N]."""
    return _bf16_f32(a) @ dequant_mxfp4(qs, sexp)


def mxfp4_matmul_experts_rows_plain(a, qs_all, s_all, expert_ids) -> torch.Tensor:
    """B12's plain version: out[i] = bf16(a[i]) @ W[ids[i]]; f32 [n_sel, N].
    Decodes one distinct expert at a time."""
    a32 = _bf16_f32(a)
    ids = expert_ids.to(torch.int64)
    out = torch.empty((a.shape[0], qs_all.shape[-1]), dtype=torch.float32, device=a.device)
    for e in torch.unique(ids).tolist():
        rows = (ids == e).nonzero()[:, 0]
        out[rows] = a32[rows] @ dequant_mxfp4(qs_all[e], s_all[e])
    return out


def mxfp4_matmul_all_experts_plain(a, qs_all, s_all) -> torch.Tensor:
    """B13's plain version: out[e] = bf16(a or a[e]) @ W[e]; f32 [E, T, N]."""
    a32 = _bf16_f32(a)
    return torch.stack([(a32[e] if a.dim() == 3 else a32) @ dequant_mxfp4(qs_all[e], s_all[e])
                        for e in range(qs_all.shape[0])])


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_weights(name, qs, sexp, k):
    n = qs.shape[-1]
    if k % SUPER or n % 64 or qs.shape[-2] * 2 != k or sexp.shape[-2:] != (k // GROUP, n) \
            or sexp.shape[:-2] != qs.shape[:-2]:
        raise ValueError(f"{name} shapes: K {k}, qs {tuple(qs.shape)}, sexp {tuple(sexp.shape)}"
                         f" (K and N must be multiples of 64)")
    if qs.dtype != torch.uint8 or sexp.dtype != torch.uint8:
        raise TypeError(f"{name}: needs uint8 qs and sexp")


def splitk_plan(m: int, k: int, n: int) -> splitk.Plan:
    """B11's grid at (M, K, N): K slices of whole scale groups (of the
    prefill body's 64-deep steps at M > 16, where a split costs about three
    steps: a 128 x 128 f32 partial against a step's 20 KB of operands)."""
    return splitk.plan(m, k, n, GROUP, split_steps=3)


def rows_plan(n_sel: int, k: int, n: int) -> splitk.Plan:
    """B12's grid for ``n_sel`` rows: K slices of whole scale groups."""
    return splitk.rows_plan(n_sel, k, n, GROUP)


def mxfp4_matmul(a: torch.Tensor, qs: torch.Tensor, sexp: torch.Tensor) -> torch.Tensor:
    """B11: C = bf16(a) @ dequant(qs, sexp) for a [M, K] bf16 or f32.
    Returns f32 [M, N]."""
    m, k = a.shape
    _check_weights("mxfp4_matmul", qs, sexp, k)
    kernels.refuse_grad("mxfp4_matmul", a, qs, sexp)
    if a.device.type == "cpu":
        return mxfp4_matmul_plain(a, qs, sexp)
    if a.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("mxfp4_matmul: needs bf16 or f32 a")
    dev = kernels.check_tensors("mxfp4_matmul", a, qs, sexp)
    n = qs.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m > splitk.MAX_M:
        a = a.to(torch.bfloat16)        # the prefill body reads bf16, as it would round
    plan = splitk_plan(m, k, n)
    scratch, counters = splitk.buffers(plan, dev)
    code = kernels.lib().rrs_mxfp4_matmul(
        a.data_ptr(), int(a.dtype == torch.bfloat16), qs.data_ptr(), sexp.data_ptr(),
        out.data_ptr(), m, k, n, plan.slice_units, splitk.ptr(scratch), splitk.ptr(counters),
        kernels.stream_ptr(dev))
    kernels.check("mxfp4_matmul", code)
    return out


def mxfp4_matmul_experts_rows(a: torch.Tensor, qs_all: torch.Tensor, s_all: torch.Tensor,
                              expert_ids: torch.Tensor) -> torch.Tensor:
    """B12: out[i] = bf16(a[i]) @ dequant(W[expert_ids[i]]) for a [n_sel, K],
    stacks [E, K//2, N] / [E, K//32, N] and int ids [n_sel] on the device
    (read there, never on the host; an id outside [0, E) is clamped).
    Returns f32 [n_sel, N]."""
    n_sel, k = a.shape
    _check_weights("mxfp4_matmul_experts_rows", qs_all, s_all, k)
    if qs_all.dim() != 3 or expert_ids.shape != (n_sel,):
        raise ValueError(f"mxfp4_matmul_experts_rows: stacks {tuple(qs_all.shape)}, ids "
                         f"{tuple(expert_ids.shape)} for {n_sel} rows")
    kernels.refuse_grad("mxfp4_matmul_experts_rows", a, qs_all, s_all)
    if a.device.type == "cpu":
        return mxfp4_matmul_experts_rows_plain(a, qs_all, s_all, expert_ids)
    n_exp, _, n = qs_all.shape
    a16 = a.to(torch.bfloat16).contiguous()
    ids = expert_ids.to(torch.int32).contiguous()
    dev = kernels.check_tensors("mxfp4_matmul_experts_rows", a16, qs_all, s_all, ids)
    out = torch.empty((n_sel, n), dtype=torch.float32, device=dev)
    plan = rows_plan(n_sel, k, n)
    scratch, counters = splitk.buffers(plan, dev)
    code = kernels.lib().rrs_mxfp4_rows(
        a16.data_ptr(), qs_all.data_ptr(), s_all.data_ptr(), ids.data_ptr(), out.data_ptr(),
        n_sel, k, n, n_exp, plan.slice_units, splitk.ptr(scratch), splitk.ptr(counters),
        kernels.stream_ptr(dev))
    kernels.check("mxfp4_matmul_experts_rows", code)
    return out


def mxfp4_matmul_all_experts(a: torch.Tensor, qs_all: torch.Tensor,
                             s_all: torch.Tensor) -> torch.Tensor:
    """B13: out[e] = bf16(a) @ dequant(W[e]) for shared a [T, K], or
    bf16(a[e]) @ dequant(W[e]) for per-expert a [E, T, K]. Returns f32
    [E, T, N]."""
    k = a.shape[-1]
    _check_weights("mxfp4_matmul_all_experts", qs_all, s_all, k)
    n_exp, _, n = qs_all.shape
    if a.dim() not in (2, 3) or (a.dim() == 3 and a.shape[0] != n_exp):
        raise ValueError(f"mxfp4_matmul_all_experts: a {tuple(a.shape)} for {n_exp} experts")
    kernels.refuse_grad("mxfp4_matmul_all_experts", a, qs_all, s_all)
    if a.device.type == "cpu":
        return mxfp4_matmul_all_experts_plain(a, qs_all, s_all)
    t = a.shape[-2]
    a16 = a.to(torch.bfloat16).contiguous()
    dev = kernels.check_tensors("mxfp4_matmul_all_experts", a16, qs_all, s_all)
    out = torch.empty((n_exp, t, n), dtype=torch.float32, device=dev)
    grid = splitk.experts_grid(n_exp, t, n)
    code = kernels.lib().rrs_mxfp4_all_experts(
        a16.data_ptr(), int(a.dim() == 3), qs_all.data_ptr(), s_all.data_ptr(), out.data_ptr(),
        n_exp, t, k, n, grid.row_tile, kernels.stream_ptr(dev))
    kernels.check("mxfp4_matmul_all_experts", code)
    return out
