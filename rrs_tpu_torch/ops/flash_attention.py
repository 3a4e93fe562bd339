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
it launches its kernel or raises. All four kernels are one template
(``csrc/attention_sm90.cuh``, a split-S decode body and a tensor-core
prefill body) with a loader per cache codec, reached through one C entry,
``rrs_flash_attention``, on the plan of ``ops/attn_split.py`` (bf16 q, D in
64/128/256).
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
    kernels.refuse_grad("flash_attention", q, k_cache, v_cache, sinks)
    if q.device.type == "cpu":
        return attention_ref(q, k_cache, v_cache, positions, scale, softcap=softcap,
                             window=window, sinks=sinks, alibi=alibi)
    return _launch("flash_attention", q, k_cache, None, v_cache, None, positions, scale, softcap,
                   window, sinks, alibi)


# kernel -> (cache codec of ops/attn_split.py, codec id of rrs_flash_attention:
# csrc/attention_sm90.cuh Codec)
_CODECS = {"flash_attention_q8": ("q8", 0), "flash_attention_q4hp": ("q4hp", 1),
           "flash_attention_q4": ("q4", 2), "flash_attention": ("bf16", 3)}


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
    kernels.refuse_grad(name, q, k_q, k_s, v_q, v_s, sinks)
    if q.device.type == "cpu":
        return attention_kvq_ref(q, k_q, k_s, v_q, v_s, positions, scale, softcap=softcap,
                                 window=window, sinks=sinks, alibi=alibi)
    return _launch(name, q, k_q, k_s, v_q, v_s, positions, scale, softcap, window, sinks, alibi)


def _launch(name, q, kc, ks, vc, vs, positions, scale, softcap, window, sinks, alibi):
    """Check the shapes and types of one of the four kernels (``ks`` / ``vs``
    None for bf16 rows), plan it and launch it."""
    codec, codec_id = _CODECS[name]
    b, t, h, d = q.shape
    if codec == "bf16":
        hkv, s = kc.shape[1], kc.shape[2]
        planes, row, want = hkv, d, torch.bfloat16
        scales_ok = True
    else:
        hkv, s = ks.shape[1], ks.shape[3]
        planes = hkv // attn_split.HEADS_PER_PLANE[codec]
        row = d // 2 if codec == "q4" else d
        want = torch.int8 if codec == "q8" else torch.uint8
        scales_ok = ks.shape == (b, hkv, 1, s) and vs.shape == ks.shape
    if h % hkv or hkv % attn_split.HEADS_PER_PLANE[codec] or kc.shape != (b, planes, s, row) \
            or vc.shape != kc.shape or not scales_ok or positions.shape != (b, t):
        raise ValueError(f"{name} shapes: q {tuple(q.shape)}, k {tuple(kc.shape)}"
                         + ("" if ks is None else f" + {tuple(ks.shape)}")
                         + f", v {tuple(vc.shape)}" + ("" if vs is None else f" + {tuple(vs.shape)}")
                         + f", positions {tuple(positions.shape)}")
    if d not in (64, 128, 256):
        raise NotImplementedError(f"{name}: head dim {d} has no CUDA kernel")
    if q.dtype != torch.bfloat16 or kc.dtype != want or vc.dtype != want or (
            ks is not None and (ks.dtype != torch.float32 or vs.dtype != torch.float32)):
        raise TypeError(f"{name}: the CUDA kernel takes bf16 q, {want} rows"
                        + ("" if ks is None else " and f32 scales"))
    dev = kernels.check_tensors(name, q, *(x for x in (kc, ks, vc, vs) if x is not None))
    pos = positions.to(device=dev, dtype=torch.int32).contiguous()
    sk = None
    if sinks is not None:
        sk = torch.as_tensor(sinks, dtype=torch.float32, device=dev).reshape(h).contiguous()
    slopes = None
    if alibi:
        slopes = torch.from_numpy(alibi_slopes_np(h, alibi)).to(dev)
    out = torch.empty_like(q)
    p = attn_split.plan(codec, b, hkv, t, h // hkv, s, d)
    scratch, counters = attn_split.buffers(p, dev)
    code = kernels.lib().rrs_flash_attention(
        codec_id, q.data_ptr(), kc.data_ptr(), splitk.ptr(ks), vc.data_ptr(), splitk.ptr(vs),
        pos.data_ptr(), splitk.ptr(sk), splitk.ptr(slopes), out.data_ptr(), b, t, h, hkv, s, d,
        float(scale), float(softcap), int(window), p.n_split, p.split_tiles,
        splitk.ptr(scratch), splitk.ptr(counters), kernels.stream_ptr(dev))
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
