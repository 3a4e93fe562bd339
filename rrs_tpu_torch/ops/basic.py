"""Normalization and positional ops: plain PyTorch.

Port of ``rrs_tpu/ops/basic.py`` (``rms_norm``, ``RopeParams``,
``rope_frequencies``, ``apply_rope``, ``_rotate``). None of these is a TPU
kernel: XLA fused them there. They compute in f32 and cast back to the
input dtype at the same places as the JAX package.

RoPE scaling: ``none`` (Qwen3) and ``llama3`` (Llama 3.1) are ported; any
other type, and per-dimension frequency factors, raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math

import torch

ROPE_SCALING_TYPES = ("none", "llama3")


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 accumulation, cast back to x's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)).to(dt)


@dataclasses.dataclass(frozen=True)
class RopeParams:
    head_dim: int
    theta: float = 10000.0
    scaling_type: str = "none"
    scale_factor: float = 1.0
    orig_context: int = 0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    neox: bool = True              # split-half (NEOX) vs interleaved pairs (NORM)
    rot_dim: int = 0               # 0 => full head_dim
    attn_factor: float = 1.0

    def __post_init__(self):
        if self.scaling_type not in ROPE_SCALING_TYPES:
            raise NotImplementedError(
                f"rope scaling {self.scaling_type!r} is not ported to rrs_tpu_torch")


def rope_frequencies(p: RopeParams, device=None) -> torch.Tensor:
    """Per-dimension inverse frequencies with scaling applied. [rot_dim//2] f32."""
    rot = p.rot_dim or p.head_dim
    exponents = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    inv_freq = 1.0 / (p.theta ** exponents)
    if p.scaling_type == "llama3":
        # llama 3.1 frequency-dependent scaling (HF Llama3RotaryEmbedding)
        low_wavelen = p.orig_context / p.low_freq_factor
        high_wavelen = p.orig_context / p.high_freq_factor
        wavelen = 2.0 * math.pi / inv_freq
        smooth = (p.orig_context / wavelen - p.low_freq_factor) / (
            p.high_freq_factor - p.low_freq_factor)
        smooth = smooth.clamp(0.0, 1.0)
        inv_freq = torch.where(
            wavelen > low_wavelen,
            inv_freq / p.scale_factor,
            torch.where(
                wavelen < high_wavelen,
                inv_freq,
                (1.0 - smooth) * inv_freq / p.scale_factor + smooth * inv_freq,
            ),
        )
    return inv_freq


def apply_rope(x: torch.Tensor, positions: torch.Tensor, p: RopeParams,
               freq_factors=None) -> torch.Tensor:
    """x [..., T, n_heads, head_dim]; positions broadcastable to [..., T]."""
    if freq_factors is not None:
        raise NotImplementedError("rope frequency factors are not ported to rrs_tpu_torch")
    rot = p.rot_dim or p.head_dim
    inv_freq = rope_frequencies(p, device=x.device)
    angles = positions[..., None].to(torch.float32) * inv_freq     # [..., T, rot//2]
    return _rotate(x, angles, p.attn_factor, rot, p.neox).to(x.dtype)


def _rotate(x, angles, mscale, rot: int, neox: bool):
    """Rotate x [..., T, H, D] by per-(position, freq) angles [..., T, rot//2].
    Returns f32."""
    cos = (torch.cos(angles) * mscale)[..., None, :]                # [..., T, 1, rot//2]
    sin = (torch.sin(angles) * mscale)[..., None, :]
    xr = x[..., :rot].to(torch.float32)
    if neox:
        x1 = xr[..., : rot // 2]
        x2 = xr[..., rot // 2:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    else:
        x1 = xr[..., 0::2]
        x2 = xr[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(xr.shape)
    if rot < x.shape[-1]:
        out = torch.cat([out, x[..., rot:].to(torch.float32)], dim=-1)
    return out
