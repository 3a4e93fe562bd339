"""Quantized KV-cache codecs: int8 rows and packed int4, each with an f32
scale per (head, slot).

Port of ``rrs_tpu/runtime/kv_codec.py``, on the same layouts, so that a
cache quantized by either package reads the same in the other. A quantized
layer cache is a ``(values, scales)`` tuple:
  q8: int8 [B, Hkv, S, D] + f32 [B, Hkv, 1, S];
  q4 head-pair (even Hkv): uint8 [B, Hkv/2, S, D] + f32 [B, Hkv, 1, S];
      byte (j, s, d) holds head 2j's element in the low nibble and head
      2j+1's in the high nibble, both stored as value + 8;
  q4 halves (odd Hkv): uint8 [B, Hkv, S, D/2] + f32 [B, Hkv, 1, S]; byte d
      holds element d in the low nibble and element d + D/2 in the high
      nibble, as two's-complement nibbles.

``quantize_rows`` is bit-equal to the JAX package's on the CPU and on the
card: its scale is one true division of two tensors (a Python float divisor
would be a CPU scalar, which CUDA's division turns into a multiply by its
reciprocal, one rounding more), and its codes round half to even.
"""

from __future__ import annotations

import torch


def kv_qmax(arr: torch.Tensor) -> float:
    return 7.0 if arr.dtype == torch.uint8 else 127.0


def quantize_rows(new: torch.Tensor, qmax: float):
    """new [..., D] -> (int8 codes in [-qmax, qmax] [..., D], f32 scales [...])."""
    x = new.to(torch.float32)
    amax = x.abs().amax(dim=-1)
    s = torch.clamp_min(amax / torch.full_like(amax, qmax), 1e-10)
    q = torch.clamp(torch.round(x / s[..., None]), -qmax, qmax).to(torch.int8)
    return q, s


def pack4(q: torch.Tensor) -> torch.Tensor:
    """int8 [-7..7] [..., D] -> uint8 [..., D/2] (halves layout)."""
    d = q.shape[-1]
    lo = (q[..., : d // 2] & 0xF).to(torch.uint8)
    hi = (q[..., d // 2:] & 0xF).to(torch.uint8) << 4
    return lo | hi


def _nibble(u: torch.Tensor) -> torch.Tensor:
    """Sign-extend the int32 nibbles 0..15 to -8..7."""
    return (u ^ 8) - 8


def unpack4(p: torch.Tensor) -> torch.Tensor:
    """uint8 [..., D/2] -> int32 [-8..7] [..., D]."""
    p32 = p.to(torch.int32)
    return torch.cat([_nibble(p32 & 15), _nibble(p32 >> 4)], dim=-1)


def pack_hp(q: torch.Tensor) -> torch.Tensor:
    """int8 [-7..7] [..., H, S, D] -> head-pair uint8 [..., H/2, S, D]
    (head 2j in the low nibble, 2j+1 in the high; values stored + 8)."""
    b = (q.to(torch.int32) + 8).to(torch.uint8)
    return b[..., 0::2, :, :] | (b[..., 1::2, :, :] << 4)


def unpack_hp(p: torch.Tensor) -> torch.Tensor:
    """uint8 [..., H/2, S, D] head-pair -> int32 [-8..7] [..., H, S, D]."""
    u = p.to(torch.int32)
    st = torch.stack([(u & 15) - 8, (u >> 4) - 8], dim=-3)          # [..., H/2, 2, S, D]
    return st.reshape(st.shape[:-4] + (st.shape[-4] * 2,) + st.shape[-2:])


def is_head_pair(arr: torch.Tensor, sc: torch.Tensor) -> bool:
    """Layout test for a q4 (values, scales) pair: head-pair stores half as
    many head planes as there are scale heads."""
    return arr.dim() == sc.dim() and arr.shape[-3] * 2 == sc.shape[-3]


def pack_like(q: torch.Tensor, arr: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    """int8 codes [..., Hkv, S, D] in the layout of the cache ``arr``."""
    if arr.dtype == torch.uint8:
        return pack_hp(q) if is_head_pair(arr, sc) else pack4(q)
    return q


def dequantize(arr: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    """(values, scales) -> f32 [B, Hkv, S, D] (or one lane's [Hkv, S, D])."""
    if arr.dtype == torch.uint8:
        arr = unpack_hp(arr) if is_head_pair(arr, sc) else unpack4(arr)
    return arr.to(torch.float32) * sc.transpose(-1, -2)
