"""Normalization and positional ops: plain PyTorch.

Port of ``rrs_tpu/ops/basic.py`` (``rms_norm``, ``layer_norm``, ``RopeParams``,
``rope_frequencies``, ``apply_rope``, ``_rotate``, ``apply_mrope``: Qwen2-VL's
M-RoPE). None of these is a TPU kernel: XLA fused them there. They compute in f32 and cast back to the
input dtype at the same places as the JAX package.

RoPE scaling: ``none`` (Qwen3), ``linear`` (gemma3's global layers: every
frequency over the factor), ``llama3`` (Llama 3.1) and ``yarn`` (gpt-oss,
deepseek2; the JAX package's simplified ramp with beta_fast 32 and beta_slow
1, and its cos/sin scale ``attn_factor`` * (1 + 0.1 ln(factor)), which MLA
cancels through ``attn_factor``) are ported, with partial rotary (``rot_dim``,
phi3) and LongRoPE's per-dimension frequency factors (phi3's
``rope_factors_long`` / ``_short``, with their attention scale
sqrt(1 + ln(factor) / ln(orig_context))); any other type raises
NotImplementedError. ``gelu_tanh`` is the tanh-approximate GELU of the gemma
GEGLU.
"""

from __future__ import annotations

import dataclasses
import math

import torch

ROPE_SCALING_TYPES = ("none", "linear", "llama3", "yarn")


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh-approximate GELU (``jax.nn.gelu(approximate=True)``)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def rms_norm(x: torch.Tensor, weight, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 accumulation, cast back to x's dtype; ``weight``
    None is the weightless norm (falcon-mamba's dt / B / C)."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    if weight is not None:
        x = x * weight.to(torch.float32)
    return x.to(dt)


def layer_norm(x: torch.Tensor, weight=None, bias=None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 accumulation, cast back to x's dtype; without
    ``weight`` / ``bias`` it is the bare normalization (RWKV6's per-head
    group norm)."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(dt)


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
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
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
    if p.scaling_type == "linear":
        inv_freq = inv_freq / p.scale_factor
    elif p.scaling_type == "llama3":
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
    elif p.scaling_type == "yarn" and p.scale_factor != 1.0 and p.orig_context > 0:
        # YaRN with the JAX package's simplified linear ramp between the
        # dims that turn beta_fast and beta_slow times over orig_context
        rot_f = float(rot)

        def find_dim(n_rot_cycles):
            return rot_f * math.log(p.orig_context / (n_rot_cycles * 2 * math.pi)) / (
                2 * math.log(p.theta))

        low = max(0.0, math.floor(find_dim(p.yarn_beta_fast)))
        high = min(rot_f - 1.0, math.ceil(find_dim(p.yarn_beta_slow)))
        dims = torch.arange(0, rot, 2, dtype=torch.float32, device=device)
        ramp = ((dims / 2 - low) / max(high - low, 1e-3)).clamp(0.0, 1.0)
        inv_freq = inv_freq / p.scale_factor * ramp + inv_freq * (1.0 - ramp)
    return inv_freq


def rope_angles(positions: torch.Tensor, p: RopeParams, freq_factors=None):
    """(angles [..., T, rot//2] f32, the cos / sin scale) of ``apply_rope``,
    on the positions' device."""
    inv_freq = rope_frequencies(p, device=positions.device)
    mscale = p.attn_factor
    if p.scaling_type == "yarn" and p.scale_factor != 1.0:
        mscale = p.attn_factor * (1.0 + 0.1 * math.log(p.scale_factor))
    if freq_factors is not None:
        inv_freq = inv_freq / freq_factors.to(device=positions.device, dtype=torch.float32)
        if p.orig_context > 0 and p.scale_factor > 1.0:
            mscale = mscale * math.sqrt(
                1.0 + math.log(p.scale_factor) / math.log(p.orig_context))
    return positions[..., None].to(torch.float32) * inv_freq, mscale


def apply_rope(x: torch.Tensor, positions: torch.Tensor, p: RopeParams,
               freq_factors=None) -> torch.Tensor:
    """x [..., T, n_heads, head_dim]; positions broadcastable to [..., T];
    ``freq_factors``: [rot_dim // 2] per-dimension frequency divisors."""
    angles, mscale = rope_angles(positions.to(x.device), p, freq_factors)
    return _rotate(x, angles, mscale, p.rot_dim or p.head_dim, p.neox).to(x.dtype)


def _rotate(x, angles, mscale, rot: int, neox: bool):
    """Rotate x [..., T, H, D] by per-(position, freq) angles [..., T, rot//2].
    Returns f32."""
    return rotate_cos_sin(x, torch.cos(angles) * mscale, torch.sin(angles) * mscale, rot, neox)


def rotate_cos_sin(x, cos, sin, rot: int, neox: bool):
    """Rotate x [..., T, H, D] by cos / sin [..., T, rot//2] (scale folded
    in). Returns f32."""
    cos, sin = cos[..., None, :], sin[..., None, :]                 # [..., T, 1, rot//2]
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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, p: RopeParams,
                sections: tuple) -> torch.Tensor:
    """Multimodal rotary (Qwen2-VL's M-RoPE): x [..., T, n_heads, head_dim],
    positions [..., T, C] integer channels (t, h, w[, e]). Frequency dim
    j < rot/2 takes its angle from the channel whose section holds j; with
    all channels equal this is ``apply_rope`` exactly."""
    rot = p.rot_dim or p.head_dim
    inv_freq = rope_frequencies(p, device=x.device)
    parts = []
    j = 0
    for c, s in enumerate(sections):
        if s <= 0:
            continue
        pc = positions[..., c].to(torch.float32)                    # [..., T]
        parts.append(pc[..., None] * inv_freq[j:j + s])
        j += s
    if j != rot // 2:
        raise ValueError(f"rope sections {sections} sum to {j}, "
                         f"need rot/2 = {rot // 2}")
    angles = torch.cat(parts, dim=-1)                               # [..., T, rot//2]
    return _rotate(x, angles, p.attn_factor, rot, p.neox).to(x.dtype)
