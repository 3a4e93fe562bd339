"""TCQ4 W4A4 matmuls: the integer decode kernels over int8 group dots (gx on
pre-quantized activations, gx2 with the activation quantization fused, gx3
with the Hadamard rotation fused too, and the tensor-core oracle a8), the
prefill dequant kernel, the dequant kernel with the rotation and the
quantization fused (fused), the paired-bias kernel over a group-interleaved
pack (pb), the int8-superblock prefill kernel (i8p) and the three
mixture-of-experts kernels over stacked expert weights (the selected experts'
rows, every expert at once, and shared rows against each selected expert),
each beside its plain PyTorch version. No model path calls fused, pb or the
selected-experts kernel, as in the JAX package.

Port of ``rrs_tpu/ops/tcq4_matmul.py``. Weights are K-major (see
``formats/tcq4.py``): qs uint8 [K//2, N], eff bf16 [K//32, N] (the effective
group scale fp32(fp16(S)) * sc / 127, rounded to bf16 on the device).

A wrapper takes its plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel (``csrc/tcq4_gx2.cu``, ``csrc/tcq4_matmul.cu``,
``csrc/tcq4_fused.cu``, ``csrc/tcq4_pb.cu``, ``csrc/tcq4_i8p.cu``,
``csrc/tcq4_experts.cu``) or raises; it never falls back. Each launch is
counted in ``kernels.LAUNCHES``.
"""

from __future__ import annotations

import torch

from rrs_tpu_torch import kernels
from rrs_tpu_torch.ops import splitk
from rrs_tpu_torch.formats.tcq4 import (
    GROUP_SIZE,
    TILE_K,
    quantize_activations_rrs,
    unpack_nibbles_torch,
)

GROUPS = TILE_K // GROUP_SIZE  # 8
A8_MAX_M = splitk.A8_MAX_M     # the a8 kernel's M limit (rrs_tpu/ops/tcq4_matmul.py:48)


def gx_viable(m: int, k: int, n: int = 0) -> bool:
    """The JAX routing gate, kept as it is so that the port picks the same
    arithmetic for every shape: decode-sized M with bounded group-expansion
    scratch (rrs_tpu/ops/tcq4_matmul.py:255)."""
    g = k // GROUP_SIZE
    return m * g * k <= 4 * 1024 * 1024 and m <= 8


def dequantize_w(qs: torch.Tensor, eff: torch.Tensor) -> torch.Tensor:
    """[K//2, N] uint8 + [K//32, N] -> [K, N] f32 (int4 * group scale), the
    values of ``unpack_nibbles_torch`` times the f32 scale. The nibbles are
    sign-extended in int8, written into the two halves of each superblock
    and scaled in place, each scale broadcast over its group (the training
    backward dequantizes every TCQ4 weight each step)."""
    k2, n = qs.shape
    q8 = qs.contiguous().view(torch.int8).reshape(k2 // (TILE_K // 2), TILE_K // 2, n)
    w = torch.empty((k2 // (TILE_K // 2), 2, TILE_K // 2, n), dtype=torch.float32,
                    device=qs.device)
    w[:, 0] = (q8 << 4) >> 4
    w[:, 1] = q8 >> 4
    return w.reshape(-1, GROUP_SIZE, n).mul_(eff.to(torch.float32)[:, None, :]).reshape(2 * k2, n)


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
# Decode: the integer group-dot family. gx2 (rrs_tpu/ops/tcq4_matmul.py:1262)
# quantizes rotated activations in its prologue, gx (:272) takes the codes
# as given, gx3 (:1394) also rotates, a8 (:89) takes the codes at M <= 32
# and sums in its own order; one CUDA body (csrc/tcq4_gx2.cu), a split-K
# weight stream whose blocks each quantize only their own slice's
# superblocks and run the group dots on the int8 tensor cores.
# ---------------------------------------------------------------------------

def gx_plan(m: int, k: int, n: int) -> splitk.Plan:
    """The grid of the gx kernels at (M, K, N): column strips times K slices
    of whole superblocks (``splitk.gx_plan``). The slices change only the
    order in which the f32 group terms are summed, never the codes."""
    return splitk.gx_plan(m, k, n)


def a8_plan(m: int, k: int, n: int) -> splitk.Plan:
    """B16's grid at (M, K, N), M <= A8_MAX_M (``splitk.a8_plan``); as in
    ``gx_plan``, the slices order only the sums."""
    return splitk.a8_plan(m, k, n)


def _gx_launch(name: str, entry, lead: tuple, m: int, k: int, n: int, plan: splitk.Plan,
               dev: torch.device) -> torch.Tensor:
    """Launch C entry ``entry`` of the gx family with its leading arguments
    ``lead`` (inputs and flags), then (out, M, K, N, slice_units, stream)
    under ``plan``; count it under ``name``."""
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    code = entry(*lead, out.data_ptr(), m, k, n, plan.slice_units, kernels.stream_ptr(dev))
    kernels.check(name, code)
    return out


def _gx_chunk(k: int) -> int:
    """The JAX gx kernels' K chunk (``_pick_bk_gx``, rrs_tpu/ops/tcq4_matmul.py:
    228-250): 512 past K = 4,096 where it divides K, else the largest
    multiple of 256 dividing K with (bk / 32) * bk <= 51,200."""
    nsb = k // TILE_K
    if k > 4096:
        return 512 if k % 512 == 0 else TILE_K
    return max(n * TILE_K for n in range(1, nsb + 1)
               if nsb % n == 0 and (n * GROUPS) * n * TILE_K <= 40 * 1280)


def _gx_dots(a_q: torch.Tensor, a_scale: torch.Tensor, qs: torch.Tensor,
             eff: torch.Tensor) -> torch.Tensor:
    """(a_q/7 * a_scale) @ dequant(w) in the gx kernels' arithmetic: per 32-group
    exact dots, times a_scale/7, times eff, summed over the groups. The group
    dots are exact: int4 times int4 sums of 32 stay below 2^24, so an f32
    matmul holds them exactly (the f32 matmul also runs on the card, where
    integer matmuls do not). On the CPU, where a K chunk (``_gx_chunk``) holds
    at most 16 groups, the groups are summed in the order of the JAX kernels
    in interpret mode, whose epilogue XLA compiles to a fused multiply-add
    chain there: y = fma(dot * s, eff, y) group by group from 0 within each
    chunk, then the chunks' sums added in turn. One reduction parts from it
    in the last f32 bit, which a bf16 output cast and the next layer's int4
    quantizer can turn into other codes (ROADMAP C2). Longer chunks (24-40
    groups, 768 <= K <= 4,096) XLA's CPU emitter sums in an order this
    does not follow; there, and on the card, where the chain would take a
    launch a group, the plain version sums in one reduction."""
    m, k = a_q.shape
    n = qs.shape[1]
    g = k // GROUP_SIZE
    w = unpack_nibbles_torch(qs).to(torch.float32).reshape(g, GROUP_SIZE, n)
    aq = a_q.to(torch.float32).reshape(m, g, GROUP_SIZE).transpose(0, 1)   # [g, m, 32]
    p = torch.bmm(aq, w)                                                  # [g, m, n] exact
    s = (a_scale.to(torch.float32) * (1.0 / 7.0)).repeat_interleave(GROUPS, dim=1)   # [m, g]
    pf = p * s.t()[:, :, None]
    e = eff.to(torch.float32)
    gc = _gx_chunk(k) // GROUP_SIZE
    if pf.device.type != "cpu" or gc > 16:
        return (pf * e[:, None, :]).sum(0)
    # an f32 product is exact in f64, so one f64 add rounded to f32 is the
    # fused multiply-add (but for a double rounding, about 2^-29 of sums);
    # every chunk's chain advances at once, a group a step
    prod = (pf.to(torch.float64) * e.to(torch.float64)[:, None, :]).reshape(g // gc, gc, m, n)
    y = torch.zeros((g // gc, m, n), dtype=torch.float32)
    for i in range(gc):
        y = (y.to(torch.float64) + prod[:, i]).to(torch.float32)
    out = y[0]
    for c in range(1, g // gc):
        out = out + y[c]
    return out


def tcq4_matmul_gx_splitk_plain(a_q: torch.Tensor, a_scale: torch.Tensor, qs: torch.Tensor,
                                eff: torch.Tensor, plan: splitk.Plan) -> torch.Tensor:
    """The gx kernels' arithmetic in their order of sums under ``plan``
    (csrc/tcq4_gx2.cu): within each K slice, superblock by superblock and
    quarter by quarter, the low-nibble group qq and then the high one
    qq + 4, y = y + (f32(dot) * (a_scale / 7)) * eff, each operation rounded
    to f32; then the slices' partials added in slice order. The kernel's
    16 x dot times (a_scale / 7) / 16 is the same product, so this is its
    output bit for bit. f32 [M, N]."""
    m, k = _check_codes("tcq4_matmul_gx_splitk_plain", a_q, a_scale)
    n = _check_weights(qs, eff, k)
    g = k // GROUP_SIZE
    w = unpack_nibbles_torch(qs).to(torch.float32).reshape(g, GROUP_SIZE, n)
    aq = a_q.to(torch.float32).reshape(m, g, GROUP_SIZE).transpose(0, 1)
    p = torch.bmm(aq, w)                                                  # [g, m, n] exact
    s7 = a_scale.to(torch.float32) * torch.tensor(1.0 / 7.0, dtype=torch.float32)
    e = eff.to(torch.float32)
    units, out = k // TILE_K, None
    for s0 in range(0, units, plan.slice_units):
        y = torch.zeros((m, n), dtype=torch.float32, device=a_q.device)
        for sb in range(s0, min(units, s0 + plan.slice_units)):
            for gi in (sb * GROUPS + qq + 4 * hi for qq in range(4) for hi in range(2)):
                y = y + (p[gi] * s7[:, sb:sb + 1]) * e[gi]
        out = y if out is None else out + y
    return out


def tcq4_matmul_gx2_plain(a_rot: torch.Tensor, qs: torch.Tensor,
                          eff: torch.Tensor) -> torch.Tensor:
    """quant(a_rot) @ dequant(w), f32 [M, N]."""
    _check_weights(qs, eff, a_rot.shape[1])
    return _gx_dots(*quantize_activations_rrs(a_rot), qs, eff)


def tcq4_matmul_gx2(a_rot: torch.Tensor, qs: torch.Tensor,
                    eff: torch.Tensor) -> torch.Tensor:
    """B1: integer-exact decode matmul with fused activation quantization,
    C = quant(a_rot) @ dequant(w). a_rot f32 [M, K] rotated, M <= 8 within
    gx_viable; bf16 eff. On the card each block of ``gx_plan``'s grid
    quantizes only its K slice's superblocks (the codes of the whole row,
    bit for bit) and sums the slices' terms in slice order."""
    m, k = a_rot.shape
    if not gx_viable(m, k):
        raise ValueError(f"tcq4_matmul_gx2: M={m}, K={k} is outside gx_viable")
    kernels.refuse_grad("tcq4_matmul_gx2", a_rot, qs, eff)
    if a_rot.device.type == "cpu":
        return tcq4_matmul_gx2_plain(a_rot, qs, eff)
    n = _check_weights(qs, eff, k)
    if a_rot.dtype != torch.float32 or qs.dtype != torch.uint8 or eff.dtype != torch.bfloat16:
        raise TypeError("tcq4_matmul_gx2: needs f32 a_rot, uint8 qs, bf16 eff")
    dev = kernels.check_tensors("tcq4_matmul_gx2", a_rot, qs, eff)
    return _gx_launch("tcq4_matmul_gx2", kernels.lib().rrs_tcq4_gx2,
                      (a_rot.data_ptr(), qs.data_ptr(), eff.data_ptr()), m, k, n,
                      gx_plan(m, k, n), dev)


def _check_codes(name: str, a_q: torch.Tensor, a_scale: torch.Tensor) -> tuple[int, int]:
    m, k = a_q.shape
    if a_scale.shape != (m, k // TILE_K):
        raise ValueError(f"{name}: a_q {tuple(a_q.shape)} with a_scale {tuple(a_scale.shape)}")
    return m, k


def tcq4_matmul_gx_plain(a_q: torch.Tensor, a_scale: torch.Tensor, qs: torch.Tensor,
                         eff: torch.Tensor) -> torch.Tensor:
    """(a_q/7 * a_scale) @ dequant(w), f32 [M, N]."""
    _check_weights(qs, eff, a_q.shape[1])
    return _gx_dots(a_q, a_scale, qs, eff)


def tcq4_matmul_gx(a_q: torch.Tensor, a_scale: torch.Tensor, qs: torch.Tensor,
                   eff: torch.Tensor) -> torch.Tensor:
    """B14: integer-exact decode matmul on pre-quantized activations,
    C = (a_q/7 * a_scale) @ dequant(w). a_q int8 [M, K] in [-7, 7], a_scale
    f32 [M, K//256] (the per-block absmax), eff bf16 or f32; M <= 8 within
    gx_viable. B1's body and grid with the codes copied in place of its
    quantizing prologue: given gx2's own codes it is bit-equal to gx2."""
    m, k = _check_codes("tcq4_matmul_gx", a_q, a_scale)
    if not gx_viable(m, k):
        raise ValueError(f"tcq4_matmul_gx: M={m}, K={k} is outside gx_viable")
    kernels.refuse_grad("tcq4_matmul_gx", a_q, a_scale, qs, eff)
    if a_q.device.type == "cpu":
        return tcq4_matmul_gx_plain(a_q, a_scale, qs, eff)
    n = _check_weights(qs, eff, k)
    if (a_q.dtype != torch.int8 or a_scale.dtype != torch.float32 or qs.dtype != torch.uint8
            or eff.dtype not in (torch.bfloat16, torch.float32)):
        raise TypeError("tcq4_matmul_gx: needs int8 a_q, f32 a_scale, uint8 qs, bf16 or f32 eff")
    dev = kernels.check_tensors("tcq4_matmul_gx", a_q, a_scale, qs, eff)
    return _gx_launch("tcq4_matmul_gx", kernels.lib().rrs_tcq4_gx,
                      (a_q.data_ptr(), a_scale.data_ptr(), qs.data_ptr(), eff.data_ptr(),
                       int(eff.dtype == torch.float32)), m, k, n, gx_plan(m, k, n), dev)


def fwht256(x: torch.Tensor) -> torch.Tensor:
    """Per-256-block normalized Walsh-Hadamard transform of f32 [..., K] as
    the gx3 kernel computes it: the natural-order butterfly, stages h = 1 ...
    128 in turn (f32 a + b to the lower index, a - b to the upper), then
    times 1/16 (exact). Equal to ``x @ hadamard_matrix(256)`` per block up to
    the order of the sums."""
    lead, k = x.shape[:-1], x.shape[-1]
    y = x.to(torch.float32).reshape(-1, k // TILE_K, TILE_K)
    h = 1
    while h < TILE_K:
        y = y.reshape(y.shape[0], y.shape[1], TILE_K // (2 * h), 2, h)
        a, b = y[..., 0, :], y[..., 1, :]
        y = torch.stack([a + b, a - b], dim=-2)
        h *= 2
    return (y.reshape(*lead, k) * 0.0625).contiguous()


def tcq4_matmul_gx3_plain(x: torch.Tensor, qs: torch.Tensor, eff: torch.Tensor) -> torch.Tensor:
    """quant(fwht256(x)) @ dequant(w), f32 [M, N]; x f32 or bf16 unrotated."""
    return tcq4_matmul_gx2_plain(fwht256(x), qs, eff)


def tcq4_matmul_gx3(x: torch.Tensor, qs: torch.Tensor, eff: torch.Tensor) -> torch.Tensor:
    """B15: integer-exact decode matmul with the rotation and the activation
    quantization fused, C = quant(fwht256(x)) @ dequant(w). x f32 or bf16
    [M, K] unrotated (a layer with no channel permutation), M <= 8 within
    gx_viable; bf16 eff. B1's body and grid: each block rotates and
    quantizes only its K slice's superblocks, so the rotation runs once a
    (row, superblock, strip) and not over the whole row in every block;
    given its own codes, B14 gives its output bit for bit."""
    m, k = x.shape
    if not gx_viable(m, k):
        raise ValueError(f"tcq4_matmul_gx3: M={m}, K={k} is outside gx_viable")
    kernels.refuse_grad("tcq4_matmul_gx3", x, qs, eff)
    if x.device.type == "cpu":
        return tcq4_matmul_gx3_plain(x, qs, eff)
    n = _check_weights(qs, eff, k)
    if (x.dtype not in (torch.float32, torch.bfloat16) or qs.dtype != torch.uint8
            or eff.dtype != torch.bfloat16):
        raise TypeError("tcq4_matmul_gx3: needs f32 or bf16 x, uint8 qs, bf16 eff")
    dev = kernels.check_tensors("tcq4_matmul_gx3", x, qs, eff)
    return _gx_launch("tcq4_matmul_gx3", kernels.lib().rrs_tcq4_gx3,
                      (x.data_ptr(), int(x.dtype == torch.bfloat16), qs.data_ptr(),
                       eff.data_ptr()), m, k, n, gx_plan(m, k, n), dev)


def tcq4_matmul_a8_plain(a_q: torch.Tensor, a_scale: torch.Tensor, qs: torch.Tensor,
                         eff: torch.Tensor) -> torch.Tensor:
    """The a8 kernel's arithmetic in the JAX kernel's order (rrs_tpu/ops/
    tcq4_matmul.py:64-82): per superblock sbacc += p_g * eff[g] over its 8
    groups in turn, then acc += sbacc * (a_scale / 7), superblock by
    superblock. f32 [M, N]."""
    m, k = _check_codes("tcq4_matmul_a8", a_q, a_scale)
    n = _check_weights(qs, eff, k)
    g = k // GROUP_SIZE
    w = unpack_nibbles_torch(qs).to(torch.float32).reshape(g, GROUP_SIZE, n)
    aq = a_q.to(torch.float32).reshape(m, g, GROUP_SIZE).transpose(0, 1)
    p = torch.bmm(aq, w).reshape(k // TILE_K, GROUPS, m, n)              # exact
    e = eff.to(torch.float32).reshape(k // TILE_K, GROUPS, 1, n)
    sbacc = torch.zeros((k // TILE_K, m, n), dtype=torch.float32, device=a_q.device)
    for gi in range(GROUPS):
        sbacc = sbacc + p[:, gi] * e[:, gi]
    s7 = a_scale.to(torch.float32) * (1.0 / 7.0)
    acc = torch.zeros((m, n), dtype=torch.float32, device=a_q.device)
    for sb in range(k // TILE_K):
        acc = acc + sbacc[sb] * s7[:, sb:sb + 1]
    return acc


A8_GROUP_ORDER = (0, 4, 1, 5, 2, 6, 3, 7)   # the kernel's walk: quarter qq, low then high


def tcq4_matmul_a8_splitk_plain(a_q: torch.Tensor, a_scale: torch.Tensor, qs: torch.Tensor,
                                eff: torch.Tensor, plan: splitk.Plan) -> torch.Tensor:
    """B16's arithmetic in its order of sums under ``plan`` (csrc/tcq4_gx2.cu,
    the a8 epilogue): within each K slice, superblock by superblock, sbacc =
    sbacc + f32(dot) * eff over the groups in A8_GROUP_ORDER, then y = y +
    sbacc * (a_scale / 7), each operation rounded to f32; then the slices'
    partials added in slice order. The kernel's 16 x sbacc times
    (a_scale / 7) / 16 is the same product, so this is its output bit for
    bit. f32 [M, N]."""
    m, k = _check_codes("tcq4_matmul_a8_splitk_plain", a_q, a_scale)
    n = _check_weights(qs, eff, k)
    g = k // GROUP_SIZE
    w = unpack_nibbles_torch(qs).to(torch.float32).reshape(g, GROUP_SIZE, n)
    aq = a_q.to(torch.float32).reshape(m, g, GROUP_SIZE).transpose(0, 1)
    p = torch.bmm(aq, w)                                                  # [g, m, n] exact
    s7 = a_scale.to(torch.float32) * torch.tensor(1.0 / 7.0, dtype=torch.float32)
    e = eff.to(torch.float32)
    units, out = k // TILE_K, None
    for s0 in range(0, units, plan.slice_units):
        y = torch.zeros((m, n), dtype=torch.float32, device=a_q.device)
        for sb in range(s0, min(units, s0 + plan.slice_units)):
            sbacc = torch.zeros((m, n), dtype=torch.float32, device=a_q.device)
            for gi in A8_GROUP_ORDER:
                sbacc = sbacc + p[sb * GROUPS + gi] * e[sb * GROUPS + gi]
            y = y + sbacc * s7[:, sb:sb + 1]
        out = y if out is None else out + y
    return out


def tcq4_matmul_a8(a_q: torch.Tensor, a_scale: torch.Tensor, qs: torch.Tensor,
                   eff: torch.Tensor) -> torch.Tensor:
    """B16: the integer oracle kernel on the int8 tensor cores,
    C = (a_q/7 * a_scale) @ dequant(w) for M <= A8_MAX_M, one exact int32
    dot per 32-group. a_q int8 [M, K] in [-7, 7], a_scale f32 [M, K//256],
    eff f32 [K//32, N]; N a multiple of 8 on the card. B1's body with the
    codes copied in place of its quantizing prologue, up to four n8 tiles of
    rows and JAX's epilogue (``tcq4_matmul_a8_splitk_plain``), under
    ``a8_plan``."""
    m, k = _check_codes("tcq4_matmul_a8", a_q, a_scale)
    if not 1 <= m <= A8_MAX_M:
        raise ValueError(f"tcq4_matmul_a8: M={m} is outside 1..{A8_MAX_M}")
    kernels.refuse_grad("tcq4_matmul_a8", a_q, a_scale, qs, eff)
    if a_q.device.type == "cpu":
        return tcq4_matmul_a8_plain(a_q, a_scale, qs, eff)
    n = _check_weights(qs, eff, k)
    if n % 8:
        raise ValueError(f"tcq4_matmul_a8: N={n} is not a multiple of 8")
    if (a_q.dtype != torch.int8 or a_scale.dtype != torch.float32 or qs.dtype != torch.uint8
            or eff.dtype != torch.float32):
        raise TypeError("tcq4_matmul_a8: needs int8 a_q, f32 a_scale, uint8 qs, f32 eff")
    dev = kernels.check_tensors("tcq4_matmul_a8", a_q, a_scale, qs, eff)
    return _gx_launch("tcq4_matmul_a8", kernels.lib().rrs_tcq4_a8,
                      (a_q.data_ptr(), a_scale.data_ptr(), qs.data_ptr(), eff.data_ptr()),
                      m, k, n, a8_plan(m, k, n), dev)


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


def splitk_plan(m: int, k: int, n: int) -> splitk.Plan:
    """The kernel's grid at (M, K, N): K slices of whole superblocks. B17
    takes the same plan, so that its dot is B4's bit for bit."""
    return splitk.plan(m, k, n, TILE_K)


def tcq4_matmul(a: torch.Tensor, qs: torch.Tensor, eff: torch.Tensor,
                fast: bool = True) -> torch.Tensor:
    """C = a @ dequant(w) for the dequantized rotated activations a f32 [M, K].
    Returns f32 [M, N], or bf16 when the padded M reaches 1024."""
    kernels.refuse_grad("tcq4_matmul", a, qs, eff)
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
    if m > splitk.MAX_M:
        a = a.to(torch.bfloat16)        # the prefill body reads bf16, as it would round
    plan = splitk_plan(m, k, n)
    scratch, counters = splitk.buffers(plan, dev)
    code = kernels.lib().rrs_tcq4_matmul(
        a.data_ptr(), int(a.dtype == torch.bfloat16), qs.data_ptr(), eff.data_ptr(),
        out.data_ptr(), m, k, n, int(out_bf16), plan.slice_units, splitk.ptr(scratch),
        splitk.ptr(counters), kernels.stream_ptr(dev))
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


def _bf16_f32(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).to(torch.float32)


# ---------------------------------------------------------------------------
# Prefill with the rotation and the activation quantization fused
# (rrs_tpu/ops/tcq4_matmul.py:732): per superblock rot = x_sb @ had, the int4
# quantize-dequantize, and the bf16 dot of B4. No model path calls it.
# ---------------------------------------------------------------------------

def fused_rotate(x: torch.Tensor, had: torch.Tensor) -> torch.Tensor:
    """x_sb @ had per 256-block in the fused kernel's order of sums: for each
    output, j = 0 ... 255 in turn, each product and each sum rounded to f32
    (separate multiplies and adds, which nothing contracts to an fma). f32
    [M, K//256, 256]."""
    m, k = x.shape
    xb = x.to(torch.float32).reshape(m, k // TILE_K, TILE_K)
    h = had.to(torch.float32)
    rot = torch.zeros_like(xb)
    for j in range(TILE_K):
        rot = rot + xb[:, :, j:j + 1] * h[j]
    return rot


def fused_codes(x: torch.Tensor, had: torch.Tensor):
    """The fused kernel's activation codes: (q f32 [M, K] in [-7, 7], amax f32
    [M, K//256]) with q = clip(rint(rot * (7 / amax)), -7, 7), both divisions
    tensor by tensor (ROADMAP queue C)."""
    rot = fused_rotate(x, had)
    amax = rot.abs().amax(dim=-1, keepdim=True)
    amax = torch.where(amax < 1e-10, torch.ones_like(amax), amax)
    q = torch.round(rot * torch.div(torch.full_like(amax, 7.0), amax)).clamp(-7, 7)
    return q.reshape(x.shape), amax[..., 0]


def fused_activations(x: torch.Tensor, had: torch.Tensor) -> torch.Tensor:
    """The dequantized activations the fused kernel feeds its dot: f32 [M, K],
    q * (amax / 7) with a true division."""
    q, amax = fused_codes(x, had)
    m, k = x.shape
    d = torch.div(amax, torch.full_like(amax, 7.0))
    return (q.reshape(m, k // TILE_K, TILE_K) * d[..., None]).reshape(m, k)


def _check_fused(x, had, qs, eff) -> tuple[int, int, int]:
    if x.dim() != 2 or x.shape[0] < 1 or had.shape != (TILE_K, TILE_K):
        raise ValueError(f"tcq4_matmul_fused: x {tuple(x.shape)} is not [M >= 1, K] or had "
                         f"{tuple(had.shape)} is not [256, 256]")
    n = _check_weights(qs, eff, x.shape[1])
    if (x.dtype not in (torch.float32, torch.bfloat16) or had.dtype != torch.float32
            or qs.dtype != torch.uint8 or eff.dtype not in (torch.bfloat16, torch.float32)):
        raise TypeError("tcq4_matmul_fused: needs f32 or bf16 x, f32 had, uint8 qs, "
                        "bf16 or f32 eff")
    return x.shape[0], x.shape[1], n


def tcq4_matmul_fused_plain(x: torch.Tensor, had: torch.Tensor, qs: torch.Tensor,
                            eff: torch.Tensor) -> torch.Tensor:
    """bf16(fused_activations(x, had)) @ bf16(q * f32(eff)), f32 sums; f32 [M, N]."""
    _check_fused(x, had, qs, eff)
    return _bf16_f32(fused_activations(x, had)) @ _bf16_f32(dequantize_w(qs, eff))


def tcq4_matmul_fused(x: torch.Tensor, had: torch.Tensor, qs: torch.Tensor,
                      eff: torch.Tensor) -> torch.Tensor:
    """B17: C = quant(x_sb @ had) @ dequant(w) in one call (the rotation
    prologue, then B4's body on its bf16 scratch under B4's split-K plan),
    f32 [M, N] at every M. x f32 or bf16 [M, K] unrotated, had f32 [256,
    256], eff bf16 or f32; N a multiple of 8 on the card. Given
    ``fused_activations(x, had)``, B4 (``tcq4_matmul``) returns the same
    output bit for bit while it stores f32 (padded M < 1024)."""
    m, k, n = _check_fused(x, had, qs, eff)
    kernels.refuse_grad("tcq4_matmul_fused", x, had, qs, eff)
    if x.device.type == "cpu":
        return tcq4_matmul_fused_plain(x, had, qs, eff)
    if n % 8:
        raise ValueError(f"tcq4_matmul_fused: N={n} is not a multiple of 8")
    dev = kernels.check_tensors("tcq4_matmul_fused", x, had, qs, eff)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    act = torch.empty((m, k), dtype=torch.bfloat16, device=dev)
    plan = splitk_plan(m, k, n)
    scratch, counters = splitk.buffers(plan, dev)
    code = kernels.lib().rrs_tcq4_fused(
        x.data_ptr(), int(x.dtype == torch.bfloat16), had.data_ptr(), qs.data_ptr(),
        eff.data_ptr(), int(eff.dtype == torch.float32), act.data_ptr(), out.data_ptr(),
        m, k, n, plan.slice_units, splitk.ptr(scratch), splitk.ptr(counters),
        kernels.stream_ptr(dev))
    kernels.check("tcq4_matmul_fused", code)
    return out


# ---------------------------------------------------------------------------
# Paired-bias dequant kernel over the group-interleaved pack
# (rrs_tpu/ops/tcq4_matmul.py:453). Byte row r of qs_gi holds k_new = 2r (low
# nibble) and 2r + 1 (high nibble), k_new = j * G + g for the original
# k = g * 32 + j (G = K / 32), so row k_new's scale is eff[k_new mod G]. A
# nibble decodes to bf16(q + 24) (the bit pattern 0x4180 | ((q + 8) << 3)),
# its product with the scale is rounded to bf16, and a 2G-deep dot of the
# hi / lo split of 24 * (group sums of a) against [e; e] cancels the bias.
# Callers: the JAX package's benchmark scripts only. The kernel walks K group
# by group (csrc/tcq4_pb.cu): B4's two bodies, K in units of 8 groups.
# ---------------------------------------------------------------------------

def pack_gi(qs: torch.Tensor) -> torch.Tensor:
    """Repack sb-layout qs (uint8 [K//2, N]) into the group-interleaved layout,
    byte-equal to the JAX ``pack_gi_np`` and ``pack_gi_jnp``."""
    k2, n = qs.shape
    k = 2 * k2
    g = k // GROUP_SIZE
    b = qs.reshape(k // TILE_K, TILE_K // 2, n)
    codes = torch.cat([b & 15, b >> 4], dim=1).reshape(k, n)
    cg = codes.reshape(g, GROUP_SIZE, n).transpose(0, 1).reshape(k, n)
    return (cg[0::2] | (cg[1::2] << 4)).contiguous()


def pb_prepare(a: torch.Tensor):
    """[M, K] f32 dequantized rotated activations -> (a_gi bf16 [M, K] in
    k_new order, ag24 bf16 [M, 2G]: the hi / lo split of 24 * the per-group
    sums of the bf16-rounded activations)."""
    m, k = a.shape
    g = k // GROUP_SIZE
    av = a.reshape(m, g, GROUP_SIZE).to(torch.bfloat16)
    a_gi = av.transpose(1, 2).reshape(m, k).contiguous()
    ag24 = av.to(torch.float32).sum(-1) * 24.0
    hi = ag24.to(torch.bfloat16)
    lo = (ag24 - hi.to(torch.float32)).to(torch.bfloat16)
    return a_gi, torch.cat([hi, lo], dim=-1).contiguous()


def pb_group_major(a_gi: torch.Tensor) -> torch.Tensor:
    """a_gi [M, K] in k_new = j * G + g order -> the activations in
    group-major order (column 32 g + j), which is ``pb_prepare``'s bf16
    activations before their transpose: the prefill kernel's operand."""
    m, k = a_gi.shape
    return a_gi.view(m, GROUP_SIZE, k // GROUP_SIZE).transpose(1, 2).reshape(m, k)


def decode_pb(qs_gi: torch.Tensor, eff: torch.Tensor) -> torch.Tensor:
    """[K//2, N] gi pack + [G, N] scales -> the kernel's weights in k_new row
    order, bf16(bf16(q + 24) * e[row mod G]) as f32 [K, N]."""
    k2, n = qs_gi.shape
    g = eff.shape[0]
    codes = torch.stack([qs_gi & 15, qs_gi >> 4], dim=1).reshape(2 * k2, n)
    biased = ((codes ^ 8).to(torch.float32) + 16.0)                  # q + 24, exact
    return _bf16_f32(biased * eff.to(torch.float32).repeat(2 * k2 // g, 1))


def _check_pb(a_gi, ag24, qs_gi, eff) -> tuple[int, int, int]:
    m, k = a_gi.shape
    n = qs_gi.shape[1]
    g = k // GROUP_SIZE
    if (m < 1 or k % TILE_K or ag24.shape != (m, 2 * g) or qs_gi.shape != (k // 2, n)
            or eff.shape != (g, n)):
        raise ValueError(f"tcq4_matmul_pb shapes: a_gi {tuple(a_gi.shape)}, ag24 "
                         f"{tuple(ag24.shape)}, qs_gi {tuple(qs_gi.shape)}, eff {tuple(eff.shape)}")
    if (a_gi.dtype != torch.bfloat16 or ag24.dtype != torch.bfloat16
            or qs_gi.dtype != torch.uint8 or eff.dtype != torch.bfloat16):
        raise TypeError("tcq4_matmul_pb: needs bf16 a_gi and ag24, uint8 qs_gi, bf16 eff")
    return m, k, n


def tcq4_matmul_pb_plain(a_gi, ag24, qs_gi, eff) -> torch.Tensor:
    """-(ag24 @ [e; e]) + a_gi @ decode_pb(qs_gi, eff), bf16 operands and f32
    sums, as the TPU kernel computes it (its output block starts at -bias).
    f32 [M, N]."""
    _check_pb(a_gi, ag24, qs_gi, eff)
    e2 = torch.cat([eff, eff]).to(torch.float32)
    bias = ag24.to(torch.float32) @ e2
    return -bias + a_gi.to(torch.float32) @ decode_pb(qs_gi, eff)


def tcq4_matmul_pb(a_gi: torch.Tensor, ag24: torch.Tensor, qs_gi: torch.Tensor,
                   eff: torch.Tensor) -> torch.Tensor:
    """B18: C = a @ dequant(w) through the paired-bias decode, f32 [M, N], any
    M. a_gi bf16 [M, K] and ag24 bf16 [M, 2G] from ``pb_prepare``, qs_gi
    from ``pack_gi``, eff bf16 [K//32, N]; N a multiple of 8 on the card.
    On the card, B4's bodies and plan with the group-major walk: at M <= 16
    the kernel reads a_gi in place, above it the wrapper first puts a_gi
    back into group-major order (``pb_group_major``, one M x K bf16 copy)."""
    m, k, n = _check_pb(a_gi, ag24, qs_gi, eff)
    kernels.refuse_grad("tcq4_matmul_pb", a_gi, ag24, qs_gi, eff)
    if a_gi.device.type == "cpu":
        return tcq4_matmul_pb_plain(a_gi, ag24, qs_gi, eff)
    if n % 8:
        raise ValueError(f"tcq4_matmul_pb: N={n} is not a multiple of 8")
    dev = kernels.check_tensors("tcq4_matmul_pb", a_gi, ag24, qs_gi, eff)
    a = a_gi if m <= splitk.MAX_M else pb_group_major(a_gi)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    plan = splitk_plan(m, k, n)
    scratch, counters = splitk.buffers(plan, dev)
    code = kernels.lib().rrs_tcq4_pb(
        a.data_ptr(), ag24.data_ptr(), qs_gi.data_ptr(), eff.data_ptr(), out.data_ptr(),
        m, k, n, plan.slice_units, splitk.ptr(scratch), splitk.ptr(counters),
        kernels.stream_ptr(dev))
    kernels.check("tcq4_matmul_pb", code)
    return out


# ---------------------------------------------------------------------------
# Prefill: int8 superblock requant (rrs_tpu/ops/tcq4_matmul.py:1107)
#
# The weights are requantized once at load to one int8 value per element with
# one f32 scale per 256-superblock and column:
#     f[g, n] = round(e[g, n] / emax[sb, n] * 127)     (int8, f8)
#     w8      = (w4 * f + 4) >> 3                      in [-127, 127]
#     w      ~= w8 * e2[sb, n],  e2 = emax * 8 / 127
# so each superblock is one exact int8 dot and a rank-1 f32 epilogue. The
# pack stores each superblock group-interleaved ("sbi": in-block row j*8+g
# holds logical element g*32+j), and the activations are permuted to match.
# ---------------------------------------------------------------------------

I8P_BM = 512          # the row tile the JAX route asks for (linear.py:402-403)


def pack_i8p(qs: torch.Tensor, eff: torch.Tensor):
    """One-time load transform of (qs, eff) in the sb layout into (qs_sbi u8
    [K//2, N], f8 i8 [K//32, N] in sbi group order, e2 f32 [K//256, N]),
    bit-equal to the JAX ``pack_i8p`` (e2 to f32 rounding)."""
    k2, n = qs.shape
    sb = 2 * k2 // TILE_K
    b = qs.reshape(sb, TILE_K // 2, n)
    codes = torch.cat([b & 15, b >> 4], dim=1)                       # [sb, 256, n]
    ci = codes.reshape(sb, GROUPS, GROUP_SIZE, n).transpose(1, 2).reshape(sb, TILE_K, n)
    qs_sbi = (ci[:, :TILE_K // 2] | (ci[:, TILE_K // 2:] << 4)).reshape(k2, n).contiguous()
    e3 = eff.reshape(sb, GROUPS, n).to(torch.float32)
    emax = e3.abs().amax(dim=1)                                      # [sb, n]
    emax = torch.where(emax > 0, emax, torch.ones_like(emax))
    f8 = torch.round(e3 / emax[:, None, :] * 127.0).to(torch.int8).reshape(sb * GROUPS, n)
    return qs_sbi, f8.contiguous(), (emax * (8.0 / 127.0)).contiguous()


def prep_a_sbi(a_q: torch.Tensor) -> torch.Tensor:
    """Permute int8 activation columns into the kernel's sbi order."""
    m, k = a_q.shape
    return a_q.reshape(m, k // TILE_K, GROUPS, GROUP_SIZE).transpose(2, 3).reshape(m, k) \
        .contiguous()


def i8p_out_bf16(m: int) -> bool:
    """The TPU kernel stores bf16 once its padded M reaches 1024, with
    m_pad = round_up(m, min(512, round_up(m, 8))) at the route's bm=512 (the
    VMEM loop that may halve bm is a TPU limit and is not carried)."""
    return _round_up(m, min(I8P_BM, _round_up(m, 8))) >= 1024


def _check_i8p(a_sbi, a_scale, qs_sbi, f8, e2) -> tuple[int, int, int]:
    m, k = a_sbi.shape
    n = qs_sbi.shape[1]
    if (k % TILE_K or a_scale.shape != (m, k // TILE_K) or qs_sbi.shape != (k // 2, n)
            or f8.shape != (k // GROUP_SIZE, n) or e2.shape != (k // TILE_K, n)):
        raise ValueError(f"i8p shapes: a {tuple(a_sbi.shape)}, a_scale {tuple(a_scale.shape)}, "
                         f"qs_sbi {tuple(qs_sbi.shape)}, f8 {tuple(f8.shape)}, "
                         f"e2 {tuple(e2.shape)}")
    return m, k, n


def decode_w8(qs_sbi: torch.Tensor, f8: torch.Tensor) -> torch.Tensor:
    """[K//2, N] sbi pack + [K//32, N] f8 -> int32 w8 [K, N] in sbi row order
    (row r of a superblock takes f8 row r % 8)."""
    k2, n = qs_sbi.shape
    sb = 2 * k2 // TILE_K
    q = qs_sbi.reshape(sb, TILE_K // 2, n).to(torch.int32)
    w4 = torch.cat([(q << 28) >> 28, (q << 24) >> 28], dim=1)             # [sb, 256, n]
    fx = f8.reshape(sb, GROUPS, n).to(torch.int32).repeat(1, TILE_K // GROUPS, 1)
    return ((w4 * fx + 4) >> 3).reshape(2 * k2, n)


def tcq4_matmul_i8p_plain(a_sbi, a_scale, qs_sbi, f8, e2) -> torch.Tensor:
    """The requantized arithmetic per superblock, in the JAX kernel's order:
    acc += p * (e2 * (a_scale / 7)). Each superblock's product is at most
    7 * 127 * 256 < 2^24, so the f32 matmul of the integer operands is exact
    (as on the card, where integer matmuls do not run)."""
    m, k, n = _check_i8p(a_sbi, a_scale, qs_sbi, f8, e2)
    w8 = decode_w8(qs_sbi, f8).to(torch.float32)
    a = a_sbi.to(torch.float32)
    ascale7 = a_scale.to(torch.float32) * (1.0 / 7.0)
    acc = torch.zeros((m, n), dtype=torch.float32, device=a_sbi.device)
    for sb in range(k // TILE_K):
        p = a[:, sb * TILE_K:(sb + 1) * TILE_K] @ w8[sb * TILE_K:(sb + 1) * TILE_K]
        acc += p * (e2[sb:sb + 1, :] * ascale7[:, sb:sb + 1])
    return acc.to(torch.bfloat16) if i8p_out_bf16(m) else acc


def i8p_plan(m: int, k: int, n: int) -> splitk.Plan:
    """The kernel's grid at (M, K, N): 128 x 128 output tiles (one block an
    SM) times K slices of whole superblocks, summed in slice order (one
    slice: the plain version's bits). A block of a split grid costs about
    three superblocks more: its 64 KB f32 partial written, and the tile's
    partials read and added by the last block (measured on the H100)."""
    return splitk.plan(m, k, n, TILE_K, row_tile=128, split_steps=3)


def tcq4_matmul_i8p(a_sbi, a_scale, qs_sbi, f8, e2) -> torch.Tensor:
    """Prefill C = (a_sbi / 7 * a_scale) @ dequant(w) on the int8 tensor
    cores. a_sbi int8 [M, K] in sbi order, a_scale f32 [M, K//256] (the
    per-block absmax). f32 [M, N], or bf16 when the padded M reaches 1024."""
    kernels.refuse_grad("tcq4_matmul_i8p", a_sbi, a_scale, qs_sbi, f8, e2)
    if a_sbi.device.type == "cpu":
        return tcq4_matmul_i8p_plain(a_sbi, a_scale, qs_sbi, f8, e2)
    m, k, n = _check_i8p(a_sbi, a_scale, qs_sbi, f8, e2)
    if (a_sbi.dtype != torch.int8 or a_scale.dtype != torch.float32 or qs_sbi.dtype != torch.uint8
            or f8.dtype != torch.int8 or e2.dtype != torch.float32):
        raise TypeError("tcq4_matmul_i8p: needs int8 a_sbi, f32 a_scale, uint8 qs_sbi, "
                        "int8 f8, f32 e2")
    dev = kernels.check_tensors("tcq4_matmul_i8p", a_sbi, a_scale, qs_sbi, f8, e2)
    out_bf16 = i8p_out_bf16(m)
    out = torch.empty((m, n), dtype=torch.bfloat16 if out_bf16 else torch.float32, device=dev)
    plan = i8p_plan(m, k, n)
    scratch, counters = splitk.buffers(plan, dev)
    code = kernels.lib().rrs_tcq4_i8p(
        a_sbi.data_ptr(), a_scale.data_ptr(), qs_sbi.data_ptr(), f8.data_ptr(), e2.data_ptr(),
        out.data_ptr(), m, k, n, int(out_bf16), plan.slice_units, splitk.ptr(scratch),
        splitk.ptr(counters), kernels.stream_ptr(dev))
    kernels.check("tcq4_matmul_i8p", code)
    return out


# ---------------------------------------------------------------------------
# Mixture of experts over stacked TCQ4 weights, qs uint8 [E, K//2, N] and eff
# bf16 [E, K//32, N]: the selected experts' rows (decode, B9;
# rrs_tpu/ops/tcq4_matmul.py:654), every expert at once (capacity dispatch,
# B10; :595) and shared rows against each selected expert (B19; :536, which
# no model path calls; eff bf16 or f32). All round the activations and each
# int4 * f32(eff) weight to bf16 and sum in f32, as the TPU kernels do.
# ---------------------------------------------------------------------------

def _expert_w(qs: torch.Tensor, eff: torch.Tensor) -> torch.Tensor:
    """One expert's [K//2, N] + [K//32, N] -> bf16-rounded f32 [K, N]."""
    return dequantize_w(qs, eff).to(torch.bfloat16).to(torch.float32)


def tcq4_matmul_experts_rows_plain(a, qs_all, eff_all, expert_ids) -> torch.Tensor:
    """B9's plain version: out[i] = bf16(a[i]) @ W[ids[i]]; f32 [n_sel, N].
    Decodes one distinct expert at a time."""
    a32 = _bf16_f32(a)
    ids = expert_ids.to(torch.int64)
    out = torch.empty((a.shape[0], qs_all.shape[-1]), dtype=torch.float32, device=a.device)
    for e in torch.unique(ids).tolist():
        rows = (ids == e).nonzero()[:, 0]
        out[rows] = a32[rows] @ _expert_w(qs_all[e], eff_all[e])
    return out


def tcq4_matmul_all_experts_plain(a, qs_all, eff_all) -> torch.Tensor:
    """B10's plain version: out[e] = bf16(a or a[e]) @ W[e]; f32 [E, T, N]."""
    a32 = _bf16_f32(a)
    return torch.stack([(a32[e] if a.dim() == 3 else a32) @ _expert_w(qs_all[e], eff_all[e])
                        for e in range(qs_all.shape[0])])


def _check_stacks(name: str, qs_all: torch.Tensor, eff_all: torch.Tensor, k: int) -> None:
    if (qs_all.dim() != 3 or k % TILE_K or qs_all.shape[1] * 2 != k or qs_all.shape[2] % 8
            or eff_all.shape != (qs_all.shape[0], k // GROUP_SIZE, qs_all.shape[2])):
        raise ValueError(f"{name} shapes: K {k}, qs {tuple(qs_all.shape)}, eff "
                         f"{tuple(eff_all.shape)} (K a multiple of 256, N of 8)")


def _check_types(name: str, a: torch.Tensor, qs_all: torch.Tensor, eff_all: torch.Tensor,
                 f32_eff: bool = False):
    eff_types = (torch.bfloat16, torch.float32) if f32_eff else (torch.bfloat16,)
    if (a.dtype not in (torch.bfloat16, torch.float32) or qs_all.dtype != torch.uint8
            or eff_all.dtype not in eff_types):
        raise TypeError(f"{name}: needs bf16 or f32 a, uint8 qs, bf16{' or f32' * f32_eff} eff")


def rows_plan(n_sel: int, k: int, n: int) -> splitk.Plan:
    """B9's grid for ``n_sel`` rows: K slices of whole superblocks."""
    return splitk.rows_plan(n_sel, k, n, TILE_K)


def tcq4_matmul_experts_rows(a: torch.Tensor, qs_all: torch.Tensor, eff_all: torch.Tensor,
                             expert_ids: torch.Tensor) -> torch.Tensor:
    """B9: out[i] = bf16(a[i]) @ dequant(W[expert_ids[i]]) for a [n_sel, K]
    (bf16 or f32) and int ids [n_sel] on the device (read there, never on the
    host; an id outside [0, E) is clamped), on B4's decode body with the
    rows on the grid, K split by ``rows_plan``. Returns f32 [n_sel, N]."""
    n_sel, k = a.shape
    _check_stacks("tcq4_matmul_experts_rows", qs_all, eff_all, k)
    if expert_ids.shape != (n_sel,):
        raise ValueError(f"tcq4_matmul_experts_rows: ids {tuple(expert_ids.shape)} for "
                         f"{n_sel} rows")
    kernels.refuse_grad("tcq4_matmul_experts_rows", a, qs_all, eff_all)
    if a.device.type == "cpu":
        return tcq4_matmul_experts_rows_plain(a, qs_all, eff_all, expert_ids)
    _check_types("tcq4_matmul_experts_rows", a, qs_all, eff_all)
    n_exp, _, n = qs_all.shape
    a16 = a.to(torch.bfloat16).contiguous()     # the kernel reads bf16, as it would round
    ids = expert_ids.to(torch.int32).contiguous()
    dev = kernels.check_tensors("tcq4_matmul_experts_rows", a16, qs_all, eff_all, ids)
    out = torch.empty((n_sel, n), dtype=torch.float32, device=dev)
    plan = rows_plan(n_sel, k, n)
    scratch, counters = splitk.buffers(plan, dev)
    code = kernels.lib().rrs_tcq4_experts_rows(
        a16.data_ptr(), qs_all.data_ptr(), eff_all.data_ptr(), ids.data_ptr(), out.data_ptr(),
        n_sel, k, n, n_exp, plan.slice_units, splitk.ptr(scratch), splitk.ptr(counters),
        kernels.stream_ptr(dev))
    kernels.check("tcq4_matmul_experts_rows", code)
    return out


def tcq4_matmul_all_experts(a: torch.Tensor, qs_all: torch.Tensor,
                            eff_all: torch.Tensor) -> torch.Tensor:
    """B10: out[e] = bf16(a) @ dequant(W[e]) for shared a [T, K], or
    bf16(a[e]) @ dequant(W[e]) for per-expert a [E, T, K] (bf16 or f32).
    Returns f32 [E, T, N]."""
    k = a.shape[-1]
    _check_stacks("tcq4_matmul_all_experts", qs_all, eff_all, k)
    n_exp, _, n = qs_all.shape
    if a.dim() not in (2, 3) or (a.dim() == 3 and a.shape[0] != n_exp):
        raise ValueError(f"tcq4_matmul_all_experts: a {tuple(a.shape)} for {n_exp} experts")
    kernels.refuse_grad("tcq4_matmul_all_experts", a, qs_all, eff_all)
    if a.device.type == "cpu":
        return tcq4_matmul_all_experts_plain(a, qs_all, eff_all)
    _check_types("tcq4_matmul_all_experts", a, qs_all, eff_all)
    t = a.shape[-2]
    a16 = a.to(torch.bfloat16).contiguous()     # the kernel reads bf16, as it would round
    dev = kernels.check_tensors("tcq4_matmul_all_experts", a16, qs_all, eff_all)
    out = torch.empty((n_exp, t, n), dtype=torch.float32, device=dev)
    grid = splitk.experts_grid(n_exp, t, n)
    code = kernels.lib().rrs_tcq4_all_experts(
        a16.data_ptr(), int(a.dim() == 3), qs_all.data_ptr(), eff_all.data_ptr(),
        out.data_ptr(), n_exp, t, k, n, grid.row_tile, kernels.stream_ptr(dev))
    kernels.check("tcq4_matmul_all_experts", code)
    return out


def tcq4_matmul_experts_plain(a, qs_all, eff_all, expert_ids) -> torch.Tensor:
    """B19's plain version: out[i] = bf16(a) @ W[ids[i]]; f32 [n_sel, M, N].
    Decodes one distinct expert at a time."""
    a32 = _bf16_f32(a)
    ids = expert_ids.to(torch.int64)
    out = torch.empty((ids.shape[0], a.shape[0], qs_all.shape[-1]), dtype=torch.float32,
                      device=a.device)
    for e in torch.unique(ids).tolist():
        out[(ids == e).nonzero()[:, 0]] = a32 @ _expert_w(qs_all[e], eff_all[e])
    return out


def tcq4_matmul_experts(a: torch.Tensor, qs_all: torch.Tensor, eff_all: torch.Tensor,
                        expert_ids: torch.Tensor) -> torch.Tensor:
    """B19: out[i] = bf16(a) @ dequant(W[expert_ids[i]]) for shared a [M, K]
    (bf16 or f32), eff bf16 or f32, and int ids [n_sel] on the device (read
    there, never on the host; an id outside [0, E) is clamped). Returns f32
    [n_sel, M, N]; with bf16 eff, out[i] is bit-equal to B10's out[ids[i]]."""
    if a.dim() != 2 or a.shape[0] < 1:
        raise ValueError(f"tcq4_matmul_experts: a {tuple(a.shape)} is not [M >= 1, K]")
    m, k = a.shape
    _check_stacks("tcq4_matmul_experts", qs_all, eff_all, k)
    if expert_ids.dim() != 1 or expert_ids.numel() < 1:
        raise ValueError(f"tcq4_matmul_experts: ids {tuple(expert_ids.shape)} is not [n_sel]")
    _check_types("tcq4_matmul_experts", a, qs_all, eff_all, f32_eff=True)
    kernels.refuse_grad("tcq4_matmul_experts", a, qs_all, eff_all)
    if a.device.type == "cpu":
        return tcq4_matmul_experts_plain(a, qs_all, eff_all, expert_ids)
    n_exp, _, n = qs_all.shape
    n_sel = expert_ids.shape[0]
    a16 = a.to(torch.bfloat16).contiguous()     # the kernel reads bf16, as it would round
    ids = expert_ids.to(torch.int32).contiguous()
    dev = kernels.check_tensors("tcq4_matmul_experts", a16, qs_all, eff_all, ids)
    out = torch.empty((n_sel, m, n), dtype=torch.float32, device=dev)
    grid = splitk.experts_grid(n_sel, m, n)
    code = kernels.lib().rrs_tcq4_experts_sel(
        a16.data_ptr(), qs_all.data_ptr(), eff_all.data_ptr(),
        int(eff_all.dtype == torch.float32), ids.data_ptr(), out.data_ptr(), n_sel, m, k, n,
        n_exp, grid.row_tile, kernels.stream_ptr(dev))
    kernels.check("tcq4_matmul_experts", code)
    return out
