"""Attention over the KV cache: the flash kernels and their plain versions.

Port of ``rrs_tpu/ops/flash_attention.py`` (``flash_attention``,
``flash_attention_q8``, ``flash_attention_q4``, ``flash_attention_q4hp`` and
the oracle ``attention_ref``). Semantics: GQA with q heads grouped onto kv
heads; the causal mask comes from per-row positions and -1 marks a padded
row, which outputs 0; ring caches with a sliding window; logit softcap;
ALiBi; per-head sinks that join only the softmax denominator. Caches are
[B, Hkv, S, D]; the quantized ones are ``runtime/kv_codec.py``'s (codes,
f32 [B, Hkv, 1, S] scales) layouts, and their function is dequantize, then
attend.

Each wrapper takes its plain version only for CPU tensors; for CUDA tensors
it launches its kernel (``csrc/flash_attention.cu`` for bf16 caches,
``csrc/flash_attention_kvq.cu`` for int8 ones, ``csrc/flash_attention_q4.cu``
for packed int4 ones, on the split-S plan of ``ops/attn_split.py``; bf16 q,
D in 64/128/256) or raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rrs_tpu_torch import kernels
from rrs_tpu_torch.ops import attn_split, splitk
from rrs_tpu_torch.runtime import kv_codec

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



# codec ids of rrs_flash_attention_kvq (csrc/flash_attention_kvq.cu, q8) and
# rrs_flash_attention_q4 (csrc/flash_attention_q4.cu)
_CODECS = {"flash_attention_q8": 0, "flash_attention_q4hp": 1, "flash_attention_q4": 2}


def attention_kvq_ref(q, k_q, k_s, v_q, v_s, positions, scale, softcap=0.0, window: int = 0,
                      sinks=None, alibi: float = 0.0):
    """Plain version of the three quantized-cache kernels: dequantize both
    caches, then ``attention_ref`` (what the JAX package runs on the CPU)."""
    return attention_ref(q, kv_codec.dequantize(k_q, k_s), kv_codec.dequantize(v_q, v_s),
                         positions, scale, softcap=softcap, window=window, sinks=sinks,
                         alibi=alibi)


def _attention_kvq(name, q, k_q, k_s, v_q, v_s, positions, scale, softcap, window, sinks,
                   alibi):
    """Shared wrapper of the three quantized-cache kernels: the plain version
    for CPU tensors, else the launch."""
    if q.device.type == "cpu":
        return attention_kvq_ref(q, k_q, k_s, v_q, v_s, positions, scale, softcap=softcap,
                                 window=window, sinks=sinks, alibi=alibi)
    b, t, h, d = q.shape
    hkv, s = k_s.shape[1], k_s.shape[3]
    planes, row = {"flash_attention_q8": (hkv, d), "flash_attention_q4hp": (hkv // 2, d),
                   "flash_attention_q4": (hkv, d // 2)}[name]
    want = torch.int8 if name == "flash_attention_q8" else torch.uint8
    if h % hkv or (name == "flash_attention_q4hp" and hkv % 2) \
            or k_q.shape != (b, planes, s, row) or v_q.shape != k_q.shape \
            or k_s.shape != (b, hkv, 1, s) or v_s.shape != k_s.shape \
            or positions.shape != (b, t):
        raise ValueError(f"{name} shapes: q {tuple(q.shape)}, k {tuple(k_q.shape)} + "
                         f"{tuple(k_s.shape)}, v {tuple(v_q.shape)} + {tuple(v_s.shape)}, "
                         f"positions {tuple(positions.shape)}")
    if d not in (64, 128, 256):
        raise NotImplementedError(f"{name}: head dim {d} has no CUDA kernel")
    if q.dtype != torch.bfloat16 or k_q.dtype != want or v_q.dtype != want \
            or k_s.dtype != torch.float32 or v_s.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes bf16 q, {want} codes and f32 scales")
    dev = kernels.check_tensors(name, q, k_q, k_s, v_q, v_s)
    pos = positions.to(device=dev, dtype=torch.int32).contiguous()
    sk = None
    if sinks is not None:
        sk = torch.as_tensor(sinks, dtype=torch.float32, device=dev).reshape(h).contiguous()
    slopes = None
    if alibi:
        slopes = torch.from_numpy(alibi_slopes_np(h, alibi)).to(dev)
    out = torch.empty_like(q)
    args = (_CODECS[name], q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
            v_s.data_ptr(), pos.data_ptr(), None if sk is None else sk.data_ptr(),
            None if slopes is None else slopes.data_ptr(), out.data_ptr(), b, t, h, hkv, s, d,
            float(scale), float(softcap), int(window))
    if name == "flash_attention_q8":
        code = kernels.lib().rrs_flash_attention_kvq(*args, kernels.stream_ptr(dev))
    else:
        p = attn_split.plan(b, planes, hkv // planes, t, h // hkv, s, d)
        scratch, counters = attn_split.buffers(p, dev)
        code = kernels.lib().rrs_flash_attention_q4(
            *args, p.n_split, p.split_tiles, splitk.ptr(scratch), splitk.ptr(counters),
            kernels.stream_ptr(dev))
    kernels.check(name, code)
    return out


def flash_attention_q8(q, k_q, k_s, v_q, v_s, positions, scale: float, softcap: float = 0.0,
                       window: int = 0, sinks=None, alibi: float = 0.0):
    """Attention over an int8 KV cache: codes [B, Hkv, S, D], scales
    [B, Hkv, 1, S]. Returns [B, T, H, D] in q's dtype."""
    return _attention_kvq("flash_attention_q8", q, k_q, k_s, v_q, v_s, positions, scale,
                          softcap, window, sinks, alibi)


def flash_attention_q4hp(q, k_q, k_s, v_q, v_s, positions, scale: float,
                         softcap: float = 0.0, window: int = 0, sinks=None,
                         alibi: float = 0.0):
    """Attention over a head-pair packed int4 KV cache: codes
    [B, Hkv/2, S, D] (+8 biased, head h in nibble h & 1), scales
    [B, Hkv, 1, S]."""
    return _attention_kvq("flash_attention_q4hp", q, k_q, k_s, v_q, v_s, positions, scale,
                          softcap, window, sinks, alibi)


def flash_attention_q4(q, k_q, k_s, v_q, v_s, positions, scale: float, softcap: float = 0.0,
                       window: int = 0, sinks=None, alibi: float = 0.0):
    """Attention over a halves-packed int4 KV cache: codes [B, Hkv, S, D/2]
    (element d in the low nibble of byte d, d + D/2 in the high one), scales
    [B, Hkv, 1, S]."""
    return _attention_kvq("flash_attention_q4", q, k_q, k_s, v_q, v_s, positions, scale,
                          softcap, window, sinks, alibi)
