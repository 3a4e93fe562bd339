"""Linear layers: dense bf16, TCQ4 W4A4 with RRS rotation, Q8_0 and MXFP4.

Port of ``rrs_tpu/models/linear.py``: the layer dataclasses, the N-pad
policy, ``fuse_linears``, the activation rotation, the route by M between
the TCQ4 kernels, and ``linear_apply`` (which also runs a LoRA-wrapped
linear: its base on the base's kernel, then the delta).

Under autograd (grad mode on and an input that requires grad) the quantized
linears run inside autograd Functions, whose forward is the same kernel
route: ``_TCQ4Apply`` with the straight-through backward of the JAX
``_tcq4_apply`` (rrs_tpu/models/linear.py:363-434: the quantizers count as
identity, dL/dx = rotate(g @ W_deq^T), and the codes and scales get none),
``_Q8Apply`` and ``_MXFP4Apply`` with the gradients ``jax.grad`` takes on the
CPU through ``q8_matmul_ref`` / ``mxfp4_matmul_ref`` (dx, and the Q8 f32
scales' gradient). The backwards are f32 products (TF32 is off). A TCQ4
linear with a channel permutation raises there, as ``jax.grad`` fails in its
Pallas call. The kernel wrappers themselves refuse such inputs
(``kernels.refuse_grad``), so no kernel cuts a gradient silently.

A TCQ4 linear carries the int8-superblock prefill pack (``i8p``) unless
``RRS_PREFILL_I8=0``, the JAX package's switch; with it every M >= 256 goes to
``tcq4_matmul_i8p``. JAX's route skips that kernel in interpret mode, so its
CPU forward never takes it; the port follows the production rule on every
device, and its CPU tests hold the i8p route to JAX at the kernel level.

``RRS_GX3`` (read at call time, default off, as in the JAX package) sends a
decode-sized TCQ4 linear without a channel permutation to ``tcq4_matmul_gx3``,
which rotates and quantizes inside the kernel. JAX never takes gx3 on the
CPU, and neither does the port: there the flag changes nothing.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from rrs_tpu_torch import kernels
from rrs_tpu_torch.formats.fwht import RRS_BLOCK, hadamard_matrix
from rrs_tpu_torch.formats.tcq4 import (
    TCQ4Tensor,
    dequantize_activations_rrs,
    effective_scales,
    quantize_activations_rrs,
)
from rrs_tpu_torch.models.adapter import LoraLinear, apply_lora_delta
from rrs_tpu_torch.ops import mxfp4_matmul as mx_mm
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
    # int8-superblock prefill pack (ops/tcq4_matmul.py pack_i8p): (qs_sbi u8
    # [K//2, N], f8 i8 [K//32, N], e2 f32 [K//256, N]), about 2x the TCQ4 bytes
    i8p: Optional[tuple] = None

    @property
    def shape(self):
        return (self.qs.shape[0] * 2, self.qs.shape[1])

    @classmethod
    def from_tensor(cls, t: TCQ4Tensor, bias=None, device="cpu") -> "TCQ4Linear":
        return cls.from_arrays(t.qs, effective_scales(t), perm=t.perm, bias=bias, device=device)

    @classmethod
    def from_arrays(cls, qs: np.ndarray, eff: np.ndarray, perm=None, bias=None,
                    device="cpu") -> "TCQ4Linear":
        """From the K-major codes and f32 effective scales (those of
        ``effective_scales``, or the native tile decode's, which are the
        same bits)."""
        gather = None
        if perm is not None:
            gather = torch.as_tensor(np.asarray(perm, np.int64) % 256, device=device)
        # eff at bf16: its rounding (<= 0.4%) is far below the int4 noise
        eff = torch.from_numpy(np.asarray(eff, np.float32)).to(torch.bfloat16).to(device)
        qs = torch.from_numpy(np.ascontiguousarray(qs)).to(device)
        return cls(
            qs=qs,
            eff=eff,
            gather=gather,
            bias=None if bias is None else torch.as_tensor(bias, device=device),
            i8p=tcq4_mm.pack_i8p(qs, eff) if want_i8p() else None,
        )


def want_i8p() -> bool:
    """Whether TCQ4 linears carry the i8p pack: ``RRS_PREFILL_I8`` as the JAX
    package reads it (rrs_tpu/models/linear.py:88), on unless set to 0."""
    return os.environ.get("RRS_PREFILL_I8", "1") != "0"


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


@dataclasses.dataclass
class MXFP4Linear:
    """MXFP4 linear (gpt-oss's native format): qs uint8 [K//2, Npad] and sexp
    uint8 [K//32, Npad] in the device layout of ``ops/mxfp4_matmul.py``,
    decoded inside the matmul kernel. Weights only: the activations stay
    bf16. ``n_logical`` is the true width when N was padded."""

    qs: torch.Tensor
    scale: torch.Tensor
    bias: Optional[torch.Tensor] = None
    n_logical: int = 0

    @property
    def shape(self):
        return (self.qs.shape[0] * 2, self.n_logical or self.qs.shape[1])

    @classmethod
    def from_gguf(cls, raw: np.ndarray, shape, bias=None, device="cpu") -> "MXFP4Linear":
        """Build from an MXFP4 GGUF payload for a logical [N, K] weight."""
        qs, sexp = mx_mm.pack_mxfp4_device(raw, shape)
        return cls(qs=torch.from_numpy(qs).to(device), scale=torch.from_numpy(sexp).to(device),
                   bias=None if bias is None else torch.as_tensor(bias, device=device),
                   n_logical=shape[0])


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
        # the fused layer drops the i8p pack, as the JAX fuse_linears does
        # (rrs_tpu/models/linear.py:247-252): its prefill takes tcq4_matmul
        return TCQ4Linear(
            qs=torch.cat([l.qs for l in layers], dim=1),
            eff=torch.cat([l.eff for l in layers], dim=1),
            gather=g0,
            bias=bias_cat(lambda l: l.qs.shape[1], torch.float32),
        )
    if isinstance(first, MXFP4Linear):
        # pad columns would land mid-concat and shift the later segments
        if any(l.n_logical and l.n_logical != l.qs.shape[1] for l in layers):
            return None
        return MXFP4Linear(
            qs=torch.cat([l.qs for l in layers], dim=1),
            scale=torch.cat([l.scale for l in layers], dim=1),
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


def _gx3_on() -> bool:
    """``RRS_GX3`` as the JAX package reads it (rrs_tpu/models/linear.py:357),
    at call time, so that one process can run with and without it."""
    return os.environ.get("RRS_GX3", "0") != "0"


def _tcq4_matmul_route_rot(rot: torch.Tensor, qs: torch.Tensor, eff: torch.Tensor,
                           i8p: Optional[tuple] = None) -> torch.Tensor:
    """Decode-sized M takes gx2 (activation quant fused into the kernel);
    prefill M >= 256 with a pack takes the int8-superblock kernel; every
    other M quantizes, dequantizes and runs the dequant kernel."""
    m, k = rot.shape
    if tcq4_mm.gx_viable(m, k, qs.shape[1]):
        return tcq4_mm.tcq4_matmul_gx2(rot, qs, eff)
    a_q, a_s = quantize_activations_rrs(rot)
    if i8p is not None and m >= 256:
        return tcq4_mm.tcq4_matmul_i8p(tcq4_mm.prep_a_sbi(a_q), a_s, *i8p)
    a = dequantize_activations_rrs(a_q, a_s)
    return tcq4_mm.tcq4_matmul(a, qs, eff)


def _tcq4_matmul_route(a_q: torch.Tensor, a_s: torch.Tensor, qs: torch.Tensor,
                       eff: torch.Tensor) -> torch.Tensor:
    """The pre-quantized entry (rrs_tpu/models/linear.py:408-416): int8 codes
    a_q [M, K] and per-block absmax a_s [M, K//256]. Decode-sized M takes the
    gx kernel, every other M dequantizes and runs the dequant kernel."""
    m, k = a_q.shape
    if tcq4_mm.gx_viable(m, k, qs.shape[1]):
        return tcq4_mm.tcq4_matmul_gx(a_q, a_s, qs, eff)
    return tcq4_mm.tcq4_matmul(dequantize_activations_rrs(a_q, a_s), qs, eff)


def _tcq4_forward(x2: torch.Tensor, qs: torch.Tensor, eff: torch.Tensor,
                  i8p: Optional[tuple]) -> torch.Tensor:
    """A TCQ4 linear without a channel permutation, f32 [M, N]: gx3 under
    ``RRS_GX3`` on the card where gx_viable, else the rotation and the route
    by M of ``_tcq4_matmul_route_rot``."""
    if x2.is_cuda and _gx3_on() and tcq4_mm.gx_viable(x2.shape[0], x2.shape[1], qs.shape[1]):
        return tcq4_mm.tcq4_matmul_gx3(x2.contiguous(), qs, eff)
    return _tcq4_matmul_route_rot(rotate_activations(x2, None).contiguous(), qs, eff, i8p)


class _TCQ4Apply(torch.autograd.Function):
    """``_tcq4_forward`` with the straight-through backward of the JAX
    ``_tcq4_apply``: rotate(g_f32 @ W_deq^T) in x's dtype (H is symmetric
    and its own inverse); the codes, the scales and the pack get none."""

    @staticmethod
    def forward(ctx, x2, qs, eff, i8p):
        ctx.save_for_backward(qs, eff)
        ctx.x_dtype = x2.dtype
        return _tcq4_forward(x2, qs, eff, i8p)

    @staticmethod
    def backward(ctx, g):
        qs, eff = ctx.saved_tensors
        gr = g.to(torch.float32) @ tcq4_mm.dequantize_w(qs, eff).t()
        return rotate_activations(gr, None).to(ctx.x_dtype), None, None, None


class _Q8Apply(torch.autograd.Function):
    """B2 forward; the gradient of the JAX CPU route ``q8_matmul_ref`` (f32
    a @ (q * scale)): dx = g @ W_deq^T, and d scale[j, n] = the sum over the
    32 rows k of group j of q[k, n] * (a^T g)[k, n]."""

    @staticmethod
    def forward(ctx, x2, q, scale):
        ctx.save_for_backward(x2, q, scale)
        return q8_mm.q8_matmul(x2, q, scale)

    @staticmethod
    def backward(ctx, g):
        x2, q, scale = ctx.saved_tensors
        g = g.to(torch.float32)
        gx = gs = None
        if ctx.needs_input_grad[0]:
            gx = (g @ q8_mm._dequant(q, scale).t()).to(x2.dtype)
        if ctx.needs_input_grad[2]:
            k, n = q.shape
            dw = x2.to(torch.float32).t() @ g                            # [K, N]
            gs = (dw.reshape(k // q8_mm.GROUP, q8_mm.GROUP, n)
                  * q.reshape(k // q8_mm.GROUP, q8_mm.GROUP, n)).sum(1)
        return gx, None, gs


class _MXFP4Apply(torch.autograd.Function):
    """B11 forward; the gradient of the JAX CPU route ``mxfp4_matmul_ref``:
    dx = g @ W_deq^T (the e8m0 scales are integers and get none)."""

    @staticmethod
    def forward(ctx, x2, qs, sexp):
        ctx.save_for_backward(qs, sexp)
        ctx.x_dtype = x2.dtype
        return mx_mm.mxfp4_matmul(x2, qs, sexp)

    @staticmethod
    def backward(ctx, g):
        qs, sexp = ctx.saved_tensors
        gx = g.to(torch.float32) @ mx_mm.dequant_mxfp4(qs, sexp).t()
        return gx.to(ctx.x_dtype), None, None


def _dense_matmul(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with an f32 result. On the card a bf16 pair stays a bf16 matmul
    (f32 accumulation, bf16 result); elsewhere the operands go to f32."""
    if x2.is_cuda and x2.dtype == w.dtype == torch.bfloat16:
        return torch.matmul(x2, w).to(torch.float32)
    return torch.matmul(x2.to(torch.float32), w.to(torch.float32))


def linear_apply(layer, x: torch.Tensor, reduce_axis=None) -> torch.Tensor:
    """y = x @ W^T (+ bias). x: [..., K] -> [..., N], in x's dtype. A
    ``LoraLinear`` runs its base on the base's route and adds its low-rank
    delta to the (logical-width) f32 product before the bias, as
    rrs_tpu/models/linear.py:447-488 does. ``reduce_axis`` (a row-parallel
    shard's ``cfg.tp_axis``): the partial products are summed over the tp
    shards in f32 before the bias and the output cast, so that sharded and
    single-device runs round alike (rrs_tpu/models/linear.py:489-494)."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    lora = None
    if isinstance(layer, LoraLinear):
        lora, layer = layer, layer.base
    if isinstance(layer, DenseLinear):
        y = _dense_matmul(x2, layer.w)
    elif isinstance(layer, Q8Linear):
        if layer.k_logical and layer.q.shape[0] != k:
            # K padded to the kernel's 256-multiple with zero-scale rows
            x2 = torch.nn.functional.pad(x2, (0, layer.q.shape[0] - k))
        mm = _Q8Apply.apply if kernels.needs_grad(x2, layer.scale) else q8_mm.q8_matmul
        y = mm(x2.contiguous(), layer.q, layer.scale)
        if layer.n_logical and layer.n_logical != y.shape[-1]:
            y = y[:, : layer.n_logical]
    elif isinstance(layer, MXFP4Linear):
        mm = _MXFP4Apply.apply if kernels.needs_grad(x2) else mx_mm.mxfp4_matmul
        y = mm(x2.contiguous(), layer.qs, layer.scale)
        if layer.n_logical and layer.n_logical != y.shape[-1]:
            y = y[:, : layer.n_logical]
    elif isinstance(layer, TCQ4Linear):
        if layer.gather is None:
            mm = _TCQ4Apply.apply if kernels.needs_grad(x2, layer.eff) else _tcq4_forward
            y = mm(x2, layer.qs, layer.eff, layer.i8p)
        elif kernels.needs_grad(x2, layer.eff):
            raise NotImplementedError(
                "the backward of a TCQ4 linear with a channel permutation (an imatrix "
                "gather): JAX's jax.grad fails in its Pallas call there too")
        else:
            rot = rotate_activations(x2, layer.gather)
            y = _tcq4_matmul_route_rot(rot.contiguous(), layer.qs, layer.eff, layer.i8p)
    else:
        raise TypeError(f"unknown linear layer {type(layer)}")
    if lora is not None:
        y = apply_lora_delta(lora, x2, y)
    if reduce_axis is not None:
        y = reduce_axis.all_reduce(y.to(torch.float32))
    if layer.bias is not None:
        y = y + layer.bias.to(y.dtype)
    y = y.to(x.dtype)
    return y.reshape(*lead, y.shape[-1])
