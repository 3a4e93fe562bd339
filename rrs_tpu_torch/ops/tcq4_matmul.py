"""TCQ4 W4A4 matmuls: the decode kernel with fused activation quantization
(gx2) and the prefill dequant kernel, each beside its plain PyTorch version.

Port of ``rrs_tpu/ops/tcq4_matmul.py``. Weights are K-major (see
``formats/tcq4.py``): qs uint8 [K//2, N], eff bf16 [K//32, N] (the effective
group scale fp32(fp16(S)) * sc / 127, rounded to bf16 on the device).

A wrapper takes its plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel (``csrc/tcq4_gx2.cu``, ``csrc/tcq4_matmul.cu``)
or raises; it never falls back. Each launch is counted in
``kernels.LAUNCHES``.
"""

from __future__ import annotations

import torch

from rrs_tpu_torch import kernels
from rrs_tpu_torch.formats.tcq4 import (
    GROUP_SIZE,
    TILE_K,
    quantize_activations_rrs,
    unpack_nibbles_torch,
)

GROUPS = TILE_K // GROUP_SIZE  # 8


def gx_viable(m: int, k: int, n: int = 0) -> bool:
    """The JAX routing gate, kept as it is so that the port picks the same
    arithmetic for every shape: decode-sized M with bounded group-expansion
    scratch (rrs_tpu/ops/tcq4_matmul.py:255)."""
    g = k // GROUP_SIZE
    return m * g * k <= 4 * 1024 * 1024 and m <= 8


def dequantize_w(qs: torch.Tensor, eff: torch.Tensor) -> torch.Tensor:
    """[K//2, N] uint8 + [K//32, N] -> [K, N] f32 (int4 * group scale)."""
    w = unpack_nibbles_torch(qs).to(torch.float32)
    return w * eff.to(torch.float32).repeat_interleave(GROUP_SIZE, dim=0)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def tcq4_out_bf16(m: int) -> bool:
    """The TPU kernel stores bf16 once its padded M reaches 1024 (bm = m below
    8, else min(128, round_up(m, 8)))."""
    bm = m if m < 8 else min(128, _round_up(m, 8))
    return _round_up(m, bm) >= 1024


def _check_weights(qs: torch.Tensor, eff: torch.Tensor, k: int) -> int:
    n = qs.shape[1]
    if k % TILE_K or qs.shape != (k // 2, n) or eff.shape != (k // GROUP_SIZE, n):
        raise ValueError(f"TCQ4 shapes: K={k}, qs {tuple(qs.shape)}, eff {tuple(eff.shape)}")
    return n


# ---------------------------------------------------------------------------
# Decode: gx2 (rrs_tpu/ops/tcq4_matmul.py:1262)
# ---------------------------------------------------------------------------

def tcq4_matmul_gx2_plain(a_rot: torch.Tensor, qs: torch.Tensor,
                          eff: torch.Tensor) -> torch.Tensor:
    """quant(a_rot) @ dequant(w), f32 [M, N]. The group dots are exact: int4
    times int4 sums of 32 stay below 2^24, so an f32 matmul holds them exactly
    (the f32 matmul also runs on the card, where integer matmuls do not)."""
    m, k = a_rot.shape
    n = _check_weights(qs, eff, k)
    a_q, amax = quantize_activations_rrs(a_rot)
    g = k // GROUP_SIZE
    w = unpack_nibbles_torch(qs).to(torch.float32).reshape(g, GROUP_SIZE, n)
    aq = a_q.to(torch.float32).reshape(m, g, GROUP_SIZE).transpose(0, 1)   # [g, m, 32]
    p = torch.bmm(aq, w)                                                  # [g, m, n] exact
    s = (amax * (1.0 / 7.0)).repeat_interleave(GROUPS, dim=1)              # [m, g]
    pf = p * s.t()[:, :, None]
    return (pf * eff.to(torch.float32)[:, None, :]).sum(0)


def tcq4_matmul_gx2(a_rot: torch.Tensor, qs: torch.Tensor,
                    eff: torch.Tensor) -> torch.Tensor:
    """Integer-exact decode matmul with fused activation quantization:
    C = quant(a_rot) @ dequant(w). a_rot f32 [M, K] rotated, M <= 8."""
    m, k = a_rot.shape
    if not gx_viable(m, k):
        raise ValueError(f"tcq4_matmul_gx2: M={m}, K={k} is outside gx_viable")
    if a_rot.device.type == "cpu":
        return tcq4_matmul_gx2_plain(a_rot, qs, eff)
    n = _check_weights(qs, eff, k)
    if a_rot.dtype != torch.float32 or qs.dtype != torch.uint8 or eff.dtype != torch.bfloat16:
        raise TypeError("tcq4_matmul_gx2: needs f32 a_rot, uint8 qs, bf16 eff")
    dev = kernels.check_tensors("tcq4_matmul_gx2", a_rot, qs, eff)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    code = kernels.lib().rrs_tcq4_gx2(
        a_rot.data_ptr(), qs.data_ptr(), eff.data_ptr(), out.data_ptr(),
        m, k, n, kernels.stream_ptr(dev))
    kernels.check("tcq4_matmul_gx2", code)
    return out


# ---------------------------------------------------------------------------
# Prefill: dequant + bf16 dot (rrs_tpu/ops/tcq4_matmul.py:895)
# ---------------------------------------------------------------------------

def tcq4_matmul_plain(a: torch.Tensor, qs: torch.Tensor, eff: torch.Tensor,
                      fast: bool = True) -> torch.Tensor:
    """C = a @ dequant(w). ``fast``: both operands rounded to bf16, f32
    accumulation (the TPU kernel's single MXU pass, for every M); else f32
    products of the exact values. bf16 out when padded M >= 1024."""
    m, k = a.shape
    _check_weights(qs, eff, k)
    w = dequantize_w(qs, eff)
    a32 = a.to(torch.float32)
    if fast:
        w = w.to(torch.bfloat16).to(torch.float32)
        a32 = a32.to(torch.bfloat16).to(torch.float32)
    y = a32 @ w
    return y.to(torch.bfloat16) if tcq4_out_bf16(m) else y


def tcq4_matmul(a: torch.Tensor, qs: torch.Tensor, eff: torch.Tensor,
                fast: bool = True) -> torch.Tensor:
    """C = a @ dequant(w) for the dequantized rotated activations a f32 [M, K].
    Returns f32 [M, N], or bf16 when the padded M reaches 1024."""
    if a.device.type == "cpu":
        return tcq4_matmul_plain(a, qs, eff, fast=fast)
    if not fast:
        raise NotImplementedError("tcq4_matmul: the f32 (fast=False) mode has "
                                  "no CUDA kernel; it runs on the CPU only")
    m, k = a.shape
    n = _check_weights(qs, eff, k)
    if a.dtype != torch.float32 or qs.dtype != torch.uint8 or eff.dtype != torch.bfloat16:
        raise TypeError("tcq4_matmul: needs f32 a, uint8 qs, bf16 eff")
    dev = kernels.check_tensors("tcq4_matmul", a, qs, eff)
    out_bf16 = tcq4_out_bf16(m)
    out = torch.empty((m, n), dtype=torch.bfloat16 if out_bf16 else torch.float32,
                      device=dev)
    code = kernels.lib().rrs_tcq4_matmul(
        a.data_ptr(), qs.data_ptr(), eff.data_ptr(), out.data_ptr(),
        m, k, n, int(out_bf16), kernels.stream_ptr(dev))
    kernels.check("tcq4_matmul", code)
    return out


def tcq4_matmul_ref(a_q, a_scale, qs, eff):
    """Integer-exact oracle (rrs_tpu/ops/tcq4_matmul.py:1001), in int64 on the
    CPU. a_q int8 [M, K] in [-7, 7], a_scale f32 [M, K//256], eff [K//32, N]."""
    a_q, a_scale = a_q.cpu(), a_scale.cpu()
    w = unpack_nibbles_torch(qs.cpu()).to(torch.int64)
    k, n = w.shape
    m = a_q.shape[0]
    prod = torch.einsum(
        "mgk,gkn->mgn",
        a_q.to(torch.int64).reshape(m, k // GROUP_SIZE, GROUP_SIZE),
        w.reshape(k // GROUP_SIZE, GROUP_SIZE, n),
    )
    per_sb = (prod.to(torch.float32) * eff.cpu().to(torch.float32)[None]).reshape(
        m, k // TILE_K, GROUPS, n).sum(2)
    return (per_sb * a_scale.to(torch.float32)[:, :, None]).sum(1) * (1.0 / 7.0)
