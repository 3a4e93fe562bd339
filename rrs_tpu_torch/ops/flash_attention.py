"""Attention over the KV cache: the flash kernel and its plain version.

Port of ``rrs_tpu/ops/flash_attention.py`` (``flash_attention`` and its
oracle ``attention_ref``). Semantics: GQA with q heads grouped onto kv heads;
the causal mask comes from per-row positions and -1 marks a padded row, which
outputs 0; ring caches with a sliding window; logit softcap; ALiBi; per-head
sinks that join only the softmax denominator. Caches are [B, Hkv, S, D].

The wrapper takes ``attention_ref`` only for CPU tensors; for CUDA tensors it
launches ``csrc/flash_attention.cu`` (bf16 q and caches, D in 64/128/256) or
raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rrs_tpu_torch import kernels

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


def alibi_slopes_np(n_heads: int, max_bias: float) -> np.ndarray:
    """Per-head ALiBi slopes: m0^(h+1) for the first 2^floor(log2(H)) heads,
    then m1^(2(h-2^floor(log2 H))+1)."""
    nhl2 = 2 ** math.floor(math.log2(n_heads))
    m0 = 2.0 ** (-max_bias / nhl2)
    m1 = 2.0 ** (-max_bias / 2.0 / nhl2)
    hs = np.arange(n_heads)
    return np.where(hs < nhl2, m0 ** (hs + 1),
                    m1 ** (2 * (hs - nhl2) + 1)).astype(np.float32)


def attention_ref(q, k_cache, v_cache, positions, scale, softcap=0.0,
                  window: int = 0, sinks=None, alibi: float = 0.0):
    """Plain version with the JAX oracle's semantics, f32 throughout.
    q [B, T, H, D]; caches [B, Hkv, S, D]; positions [B, T]."""
    b, t, h, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    dev = q.device
    qf = q.reshape(b, t, hkv, g, d).to(torch.float32)
    kf = k_cache.to(torch.float32)
    vf = v_cache.to(torch.float32)
    scores = torch.einsum("bthgd,bhsd->bhgts", qf, kf) * scale
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    pos = positions.to(torch.int64)
    kv_pos = torch.arange(s, dtype=torch.int64, device=dev)
    if window > 0:
        off = torch.remainder(pos[:, :, None] - kv_pos[None, None, :], s)
        real = pos[:, :, None] - off
        mask = (real >= 0) & (real > pos[:, :, None] - window)
    else:
        real = kv_pos[None, None, :].expand(b, t, s)
        mask = kv_pos[None, None, :] <= pos[:, :, None]          # [B, T, S]
    if alibi:
        slopes = torch.from_numpy(alibi_slopes_np(h, alibi)).to(dev).reshape(
            1, hkv, g, 1, 1)
        dist = (real - pos[:, :, None]).to(torch.float32)
        scores = scores + slopes * dist[:, None, None, :, :]
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.tensor(NEG_INF, dtype=torch.float32, device=dev))
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    denom = e.sum(dim=-1, keepdim=True)
    if sinks is not None:
        sk = torch.as_tensor(sinks, dtype=torch.float32, device=dev).reshape(
            1, hkv, g, 1, 1)
        denom = denom + torch.exp(sk - m)
    probs = e / denom.clamp_min(1e-30)
    probs = torch.where(mask[:, None, None, :, :].any(-1, keepdim=True), probs,
                        torch.zeros((), dtype=torch.float32, device=dev))
    ctx = torch.einsum("bhgts,bhsd->bthgd", probs, vf)
    return ctx.reshape(b, t, h, d).to(q.dtype)


def flash_attention(q, k_cache, v_cache, positions, scale: float,
                    softcap: float = 0.0, window: int = 0, sinks=None,
                    alibi: float = 0.0):
    """Online-softmax attention. q [B, T, H, D], caches [B, Hkv, S, D],
    positions [B, T] int32 (row attends slots <= its position; -1 = none).
    Returns [B, T, H, D] in q's dtype."""
    if q.device.type == "cpu":
        return attention_ref(q, k_cache, v_cache, positions, scale, softcap=softcap,
                             window=window, sinks=sinks, alibi=alibi)
    b, t, h, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    if h % hkv or k_cache.shape != (b, hkv, s, d) or v_cache.shape != k_cache.shape \
            or positions.shape != (b, t):
        raise ValueError(f"flash_attention shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}, "
                         f"positions {tuple(positions.shape)}")
    if d not in (64, 128, 256):
        raise NotImplementedError(f"flash_attention: head dim {d} has no CUDA kernel")
    if q.dtype != torch.bfloat16 or k_cache.dtype != torch.bfloat16 \
            or v_cache.dtype != torch.bfloat16:
        raise TypeError("flash_attention: the CUDA kernel takes bf16 q and caches")
    dev = kernels.check_tensors("flash_attention", q, k_cache, v_cache)
    pos = positions.to(device=dev, dtype=torch.int32).contiguous()
    sk = None
    if sinks is not None:
        sk = torch.as_tensor(sinks, dtype=torch.float32, device=dev).reshape(h).contiguous()
    slopes = None
    if alibi:
        slopes = torch.from_numpy(alibi_slopes_np(h, alibi)).to(dev)
    out = torch.empty_like(q)
    code = kernels.lib().rrs_flash_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        None if sk is None else sk.data_ptr(),
        None if slopes is None else slopes.data_ptr(),
        out.data_ptr(), b, t, h, hkv, s, d, float(scale), float(softcap),
        int(window), kernels.stream_ptr(dev))
    kernels.check("flash_attention", code)
    return out

