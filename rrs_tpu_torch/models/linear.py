"""Linear layers: dense bf16, TCQ4 W4A4 with RRS rotation, and Q8_0.

Port of ``rrs_tpu/models/linear.py``: the layer dataclasses, the N-pad
policy, ``fuse_linears``, the activation rotation, the route by M between
the two TCQ4 kernels, and ``linear_apply``. The straight-through backward
waits for the training slice; the int8-superblock prefill pack (``i8p``) is
not carried, so every M that gx2 does not take goes to ``tcq4_matmul``, the
JAX package's behaviour under ``RRS_PREFILL_I8=0``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rrs_tpu_torch.formats.fwht import RRS_BLOCK, hadamard_matrix
from rrs_tpu_torch.formats.tcq4 import (
    TCQ4Tensor,
    dequantize_activations_rrs,
    effective_scales,
    quantize_activations_rrs,
)
from rrs_tpu_torch.ops import q8_matmul as q8_mm
from rrs_tpu_torch.ops import tcq4_matmul as tcq4_mm


@dataclasses.dataclass
class DenseLinear:
    """Unquantized linear; w is [K, N] (already transposed for x @ w)."""

    w: torch.Tensor
    bias: Optional[torch.Tensor] = None

    @property
    def shape(self):
        return tuple(self.w.shape)


@dataclasses.dataclass
class TCQ4Linear:
    """TCQ4 W4A4 linear in the K-major kernel layout.

    ``gather`` is the optional int64 [K] block-local channel permutation
    (perm % 256) applied to the activations before rotation.
    """

    qs: torch.Tensor                  # uint8 [K//2, N]
    eff: torch.Tensor                 # bf16 [K//32, N] effective group scales
    gather: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None

    @property
    def shape(self):
        return (self.qs.shape[0] * 2, self.qs.shape[1])

    @classmethod
    def from_tensor(cls, t: TCQ4Tensor, bias=None, device="cpu") -> "TCQ4Linear":
        gather = None
        if t.perm is not None:
            gather = torch.as_tensor(np.asarray(t.perm, np.int64) % 256, device=device)
        # eff at bf16: its rounding (<= 0.4%) is far below the int4 noise
        eff = torch.from_numpy(effective_scales(t).astype(np.float32)).to(torch.bfloat16)
        return cls(
            qs=torch.from_numpy(np.ascontiguousarray(t.qs)).to(device),
            eff=eff.to(device),
            gather=gather,
            bias=None if bias is None else torch.as_tensor(bias, device=device),
        )


def _pad_n(a: np.ndarray, mult: int = 0) -> np.ndarray:
    """Pad axis 1 (N) to a tile-friendly multiple (see n_pad_width). Padded
    columns produce outputs that the caller slices off."""
    n_pad = n_pad_width(a.shape[1], mult)
    if n_pad == a.shape[1]:
        return a
    return np.pad(a, ((0, 0), (0, n_pad - a.shape[1])))


def n_pad_width(n: int, mult: int = 0) -> int:
    """Big vocabularies pad to 2048-multiples, small N to 128."""
    if mult == 0:
        mult = 2048 if n > 8192 else 128
    return (n + mult - 1) // mult * mult


@dataclasses.dataclass
class Q8Linear:
    """Q8_0 linear: q int8 [Kpad, Npad] K-major, scale f32 [Kpad//32, Npad].
    ``n_logical`` is the true width, ``k_logical`` the true depth when K was
    padded to a 256-multiple (0 when not)."""

    q: torch.Tensor
    scale: torch.Tensor
    bias: Optional[torch.Tensor] = None
    n_logical: int = 0
    k_logical: int = 0

    @property
    def shape(self):
        return (self.k_logical or self.q.shape[0], self.n_logical or self.q.shape[1])

    @classmethod
    def from_q8_gguf(cls, raw: np.ndarray, shape, bias=None, device="cpu") -> "Q8Linear":
        """Build from a Q8_0 GGUF payload for a logical [N, K] weight."""
        from rrs_tpu_torch.formats.kquants import q8_blocks

        n, k = shape
        q, d = q8_blocks(raw, shape)
        kpad = -(-k // 256) * 256
        q_kn = np.pad(np.ascontiguousarray(q.T), ((0, kpad - k), (0, 0)))
        d_kn = np.pad(np.ascontiguousarray(d.T), ((0, kpad // 32 - k // 32), (0, 0)))
        return cls(
            q=torch.from_numpy(np.ascontiguousarray(_pad_n(q_kn))).to(device),
            scale=torch.from_numpy(np.ascontiguousarray(_pad_n(d_kn))).to(device),
            bias=None if bias is None else torch.as_tensor(bias, device=device),
            n_logical=n,
            k_logical=k if kpad != k else 0,
        )

    @classmethod
    def quantize(cls, w: np.ndarray, bias=None, device="cpu") -> "Q8Linear":
        """Quantize an [N, K] f32 weight with quantize_row_q8_0 semantics."""
        from rrs_tpu_torch.formats.kquants import quantize_q8_0

        raw = quantize_q8_0(np.asarray(w, np.float32))
        return cls.from_q8_gguf(raw, w.shape, bias=bias, device=device)


def fuse_linears(layers: list):
    """Concatenate same-K linears along N (qkv / gate-up fusion): one kernel
    launch instead of several. Returns None when they cannot share one."""
    first = layers[0]

    def bias_cat(width_of, dtype):
        if not any(l.bias is not None for l in layers):
            return None
        dev = next(l.bias.device for l in layers if l.bias is not None)
        return torch.cat([
            l.bias if l.bias is not None
            else torch.zeros((width_of(l),), dtype=dtype, device=dev)
            for l in layers
        ])

    if isinstance(first, DenseLinear):
        return DenseLinear(w=torch.cat([l.w for l in layers], dim=1),
                           bias=bias_cat(lambda l: l.w.shape[1], first.w.dtype))
    if isinstance(first, TCQ4Linear):
        g0 = first.gather
        same = all(
            (l.gather is None and g0 is None)
            or (l.gather is not None and g0 is not None and torch.equal(l.gather, g0))
            for l in layers
        )
        if not same:
            return None    # different perms cannot share one rotation
        return TCQ4Linear(
            qs=torch.cat([l.qs for l in layers], dim=1),
            eff=torch.cat([l.eff for l in layers], dim=1),
            gather=g0,
            bias=bias_cat(lambda l: l.qs.shape[1], torch.float32),
        )
    if isinstance(first, Q8Linear):
        if any(l.n_logical and l.n_logical != l.q.shape[1] for l in layers):
            return None
        return Q8Linear(
            q=torch.cat([l.q for l in layers], dim=1),
            scale=torch.cat([l.scale for l in layers], dim=1),
            bias=bias_cat(lambda l: l.q.shape[1], torch.float32),
            k_logical=first.k_logical,
        )
    return None


_HADAMARD: dict = {}


def _hadamard_f32(device) -> torch.Tensor:
    key = str(device)
    if key not in _HADAMARD:
        _HADAMARD[key] = torch.from_numpy(
            hadamard_matrix(RRS_BLOCK).astype(np.float32)).to(device)
    return _HADAMARD[key]


def rotate_activations(x: torch.Tensor, gather: Optional[torch.Tensor]) -> torch.Tensor:
    """Block-local perm gather + per-256-block FWHT as one f32 matmul
    (TF32 is off: the products are full f32). Returns f32 [..., K]."""
    k = x.shape[-1]
    lead = x.shape[:-1]
    if k % RRS_BLOCK:
        raise ValueError(f"TCQ4 activation width {k} is not a multiple of {RRS_BLOCK}")
    xb = x.reshape(*lead, k // RRS_BLOCK, RRS_BLOCK).to(torch.float32)
    if gather is not None:
        idx = gather.reshape(k // RRS_BLOCK, RRS_BLOCK).expand(xb.shape)
        xb = torch.gather(xb, -1, idx)
    rot = torch.matmul(xb, _hadamard_f32(x.device))
    return rot.reshape(*lead, k)


def _tcq4_matmul_route_rot(rot: torch.Tensor, qs: torch.Tensor,
                           eff: torch.Tensor) -> torch.Tensor:
    """Decode-sized M takes gx2 (activation quant fused into the kernel);
    every other M quantizes, dequantizes and runs the dequant kernel."""
    m, k = rot.shape
    if tcq4_mm.gx_viable(m, k, qs.shape[1]):
        return tcq4_mm.tcq4_matmul_gx2(rot, qs, eff)
    a_q, a_s = quantize_activations_rrs(rot)
    a = dequantize_activations_rrs(a_q, a_s)
    return tcq4_mm.tcq4_matmul(a, qs, eff)


def _dense_matmul(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with an f32 result. On the card a bf16 pair stays a bf16 matmul
    (f32 accumulation, bf16 result); elsewhere the operands go to f32."""
    if x2.is_cuda and x2.dtype == w.dtype == torch.bfloat16:
        return torch.matmul(x2, w).to(torch.float32)
    return torch.matmul(x2.to(torch.float32), w.to(torch.float32))


def linear_apply(layer, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W^T (+ bias). x: [..., K] -> [..., N], in x's dtype."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    if isinstance(layer, DenseLinear):
        y = _dense_matmul(x2, layer.w)
    elif isinstance(layer, Q8Linear):
        if layer.k_logical and layer.q.shape[0] != k:
            # K padded to the kernel's 256-multiple with zero-scale rows
            x2 = torch.nn.functional.pad(x2, (0, layer.q.shape[0] - k))
        y = q8_mm.q8_matmul(x2.contiguous(), layer.q, layer.scale)
        if layer.n_logical and layer.n_logical != y.shape[-1]:
            y = y[:, : layer.n_logical]
    elif isinstance(layer, TCQ4Linear):
        rot = rotate_activations(x2, layer.gather)
        y = _tcq4_matmul_route_rot(rot.contiguous(), layer.qs, layer.eff)
    else:
        raise TypeError(f"unknown linear layer {type(layer)}")
    if layer.bias is not None:
        y = y + layer.bias.to(y.dtype)
    y = y.to(x.dtype)
    return y.reshape(*lead, y.shape[-1])
