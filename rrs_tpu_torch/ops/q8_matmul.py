"""Q8_0 weight matmul (the lm_head), kernel and plain version.

Port of ``rrs_tpu/ops/q8_matmul.py``. Layout: q int8 [K, N] K-major, scale
f32 [K//32, N]. The kernel (``csrc/q8_matmul.cu``) and the plain version both
round the activations and the dequantized weights to bf16 and accumulate in
f32, the arithmetic of the TPU kernel's bf16 MXU pass; ``q8_matmul_ref`` is
the JAX package's f32 oracle. The kernel splits K by ``splitk_plan``
(``ops/splitk.py``), which changes only the order of the f32 sums.
"""

from __future__ import annotations

import torch

from rrs_tpu_torch import kernels
from rrs_tpu_torch.ops import splitk

GROUP = 32


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    k, n = q.shape
    return (q.to(torch.float32).reshape(k // GROUP, GROUP, n)
            * scale.to(torch.float32)[:, None, :]).reshape(k, n)


def q8_matmul_ref(a: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 oracle (rrs_tpu/ops/q8_matmul.py:92)."""
    return a.to(torch.float32) @ _dequant(q, scale)


def q8_matmul_plain(a: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """bf16(a) @ bf16(q * scale) with f32 accumulation; f32 [M, N]."""
    w = _dequant(q, scale).to(torch.bfloat16).to(torch.float32)
    return a.to(torch.bfloat16).to(torch.float32) @ w


def splitk_plan(m: int, k: int, n: int) -> splitk.Plan:
    """The kernel's grid at (M, K, N): K slices of whole scale groups."""
    return splitk.plan(m, k, n, GROUP)


def q8_matmul(a: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """C = a @ dequant(q, scale) for a [M, K] bf16 or f32. Returns f32 [M, N]."""
    m, k = a.shape
    n = q.shape[1]
    if k % 256 or q.shape[0] != k or scale.shape != (k // GROUP, n):
        raise ValueError(f"q8_matmul shapes: a {tuple(a.shape)}, q {tuple(q.shape)}, "
                         f"scale {tuple(scale.shape)}")
    kernels.refuse_grad("q8_matmul", a, q, scale)
    if a.device.type == "cpu":
        return q8_matmul_plain(a, q, scale)
    if a.dtype not in (torch.bfloat16, torch.float32) or q.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError("q8_matmul: needs bf16/f32 a, int8 q, f32 scale")
    dev = kernels.check_tensors("q8_matmul", a, q, scale)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m > splitk.MAX_M:
        a = a.to(torch.bfloat16)        # the prefill body reads bf16, as it would round
    plan = splitk_plan(m, k, n)
    scratch, counters = splitk.buffers(plan, dev)
    code = kernels.lib().rrs_q8_matmul(
        a.data_ptr(), int(a.dtype == torch.bfloat16), q.data_ptr(), scale.data_ptr(),
        out.data_ptr(), m, k, n, plan.slice_units, splitk.ptr(scratch), splitk.ptr(counters),
        kernels.stream_ptr(dev))
    kernels.check("q8_matmul", code)
    return out

