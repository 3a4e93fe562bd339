"""Llama-family transformer forward: every attention family of the JAX
package (Llama 3, Mistral, Qwen2.5, Qwen3, gpt-oss, DeepSeek-V2 / V3 with
MLA, gemma2 / 3, granite, minicpm, olmo2, phi3).

Port of ``rrs_tpu/models/llama.py``: RMSNorm -> QKV (+ bias, + per-head q/k
norm, or olmo2's norm over the whole projection) -> RoPE (per layer: sliding
layers may take their own base; partial rotary and LongRoPE factors) -> KV
store -> GQA flash attention (window and sinks on sliding gpt-oss layers, a
logit softcap on gemma2) -> output projection -> RMSNorm -> SwiGLU or GEGLU
FFN, or the MoE FFN (``models/moe.py``), with gemma's sandwich norms, olmo2's
post-norm-only layers and granite / minicpm's residual scale around them;
then the final norm, the lm_head, the logits divisor and the final softcap.
DeepSeek's layers take ``mla_attention``, multi-head latent attention in its
absorbed-MQA form over one cached [k_pe | c_kv] row a position; its score,
softmax and value products are plain torch, as they are plain jnp in the JAX
package, and every TCQ4 / Q8 linear around them takes the ported kernels.

Weights are plain dataclasses of tensors. Where the JAX forward returns new
caches, this one writes the new K/V rows into the preallocated per-layer
[B, Hkv, S_l, D] caches in place and returns only the logits. A sliding
layer's cache is a ring of S_l slots (position p at slot p % S_l) whose rows
may wrap mid-chunk, written as two slices. A quantized cache (a ``(codes,
scales)`` pair, ``runtime/kv_codec.py``) takes the new rows quantized and
packed, and is read by its own attention kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from rrs_tpu_torch.models.adapter import LoraLinear
from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.models.linear import (
    DenseLinear,
    MXFP4Linear,
    Q8Linear,
    TCQ4Linear,
    linear_apply,
    n_pad_width,
    want_i8p,
)
from rrs_tpu_torch.models.moe import MoEWeights, moe_ffn
from rrs_tpu_torch.ops.basic import RopeParams, apply_mrope, apply_rope, gelu_tanh, rms_norm
from rrs_tpu_torch.ops.flash_attention import (attention_kvq_ref, attention_ref, flash_attention,
                                               flash_attention_q4, flash_attention_q4hp,
                                               flash_attention_q8)
from rrs_tpu_torch.runtime import kv_codec


@dataclasses.dataclass
class LayerWeights:
    attn_norm: torch.Tensor
    wq: Any
    wk: Any
    wv: Any
    wo: Any
    q_norm: Optional[torch.Tensor]
    k_norm: Optional[torch.Tensor]
    ffn_norm: torch.Tensor
    w_gate: Any
    w_up: Any
    w_down: Any
    wqkv: Any = None                  # fused q|k|v projection (optional)
    w_gateup: Any = None              # fused gate|up projection (optional)
    moe: Any = None                   # MoEWeights of an MoE layer (models/moe.py)
    attn_sinks: Optional[torch.Tensor] = None   # [H] f32 per-head sink logits (gpt-oss)
    attn_post_norm: Optional[torch.Tensor] = None   # gemma2 / 3, olmo2: after attention
    ffn_post_norm: Optional[torch.Tensor] = None    # gemma2 / 3, olmo2: after the FFN
    # MLA (deepseek2): the q LoRA down projection (wq is then its up
    # projection and q_norm its norm), the joint [c_kv | k_pe] projection
    # (k_norm is c_kv's norm), and the per-head absorption and
    # decompression factors wk_b [H, nope, r] and wv_b [H, r, v] (bf16)
    wq_a: Any = None
    wkv_a: Any = None
    wk_b: Optional[torch.Tensor] = None
    wv_b: Optional[torch.Tensor] = None


@dataclasses.dataclass
class ModelWeights:
    # [vocab, n_embd] bf16, or a Q8_0-packed (q int8 [V, E], scale [V, E//32])
    # pair whose rows are dequantized per looked-up token
    embed: Any
    layers: list
    final_norm: torch.Tensor
    lm_head: Any
    rope_factors: Optional[torch.Tensor] = None   # [rot // 2] LongRoPE divisors (phi3)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


def embed_rows(embed, tokens: torch.Tensor) -> torch.Tensor:
    """Token-embedding row gather, including the Q8-packed table form."""
    if isinstance(embed, tuple):
        q, s = embed
        rows = q[tokens].to(torch.bfloat16)                        # [B, T, E]
        sc = s[tokens].to(torch.bfloat16)                          # [B, T, E/32]
        b, t, e = rows.shape
        return (rows.reshape(b, t, e // 32, 32) * sc[..., None]).reshape(b, t, e)
    return embed[tokens]


def rope_params(cfg: ModelConfig, swa: bool = False) -> RopeParams:
    if swa and cfg.rope_theta_swa > 0:
        # sliding layers with their own base take no long-context scaling
        return RopeParams(head_dim=cfg.head_dim, theta=cfg.rope_theta_swa, neox=cfg.rope_neox,
                          rot_dim=cfg.rope_rot_dim)
    return RopeParams(
        head_dim=cfg.head_dim,
        theta=cfg.rope_theta,
        scaling_type=cfg.rope_scaling_type,
        scale_factor=cfg.rope_scale_factor,
        orig_context=cfg.rope_orig_context,
        neox=cfg.rope_neox,
        rot_dim=cfg.rope_rot_dim,
    )


def mla_rope_params(cfg: ModelConfig) -> RopeParams:
    """RoPE of MLA's rope sub-dimension (q_pe, k_pe): interleaved pairs, and
    ``attn_factor`` = 1 / (1 + 0.1 ln s), which cancels apply_rope's YaRN
    mscale: DeepSeek moves that magnitude into the kq scale instead
    (``mla_kq_scale``)."""
    attn_factor = 1.0
    if cfg.rope_scaling_type == "yarn" and cfg.rope_scale_factor != 1.0:
        attn_factor = 1.0 / (1.0 + 0.1 * math.log(cfg.rope_scale_factor))
    return RopeParams(head_dim=cfg.qk_rope_dim, theta=cfg.rope_theta,
                      scaling_type=cfg.rope_scaling_type, scale_factor=cfg.rope_scale_factor,
                      orig_context=cfg.rope_orig_context, neox=False, attn_factor=attn_factor)


def mla_kq_scale(cfg: ModelConfig) -> float:
    """mscale^2 / sqrt(head_dim), mscale = 1 + 0.1 * rope_yarn_log_mul * ln s
    (head_dim is the decompressed qk head size, e.g. 192)."""
    mscale = 1.0
    if (cfg.rope_scaling_type == "yarn" and cfg.rope_scale_factor != 1.0
            and cfg.rope_yarn_log_mul):
        mscale = 1.0 + 0.1 * cfg.rope_yarn_log_mul * math.log(cfg.rope_scale_factor)
    return float(mscale * mscale / math.sqrt(cfg.head_dim))


def _lane_slots(cache_slots, mask_positions) -> list[int]:
    """First cache slot of each lane's run, -1 for a padded lane (mask -1)."""
    slots = torch.as_tensor(cache_slots).reshape(len(cache_slots), -1)[:, 0].tolist()
    masks = torch.as_tensor(mask_positions).reshape(len(mask_positions), -1)[:, 0].tolist()
    return [sl if mk >= 0 else -1 for sl, mk in zip(slots, masks)]


def _layer_starts(slots: list[int], s_l: int, t: int, ring: bool) -> list:
    """Per-lane start slots in one layer's cache of s_l slots, None (no
    write) for a padded lane. Full layers: a lane's own slot, clamped to [0,
    s_l - t] like the JAX dynamic_update_slice. Rings: slot % s_l. A padded
    lane writes nothing: the JAX package parks its rows at slots s_l - t ..
    s_l - 1 of a full layer, which overwrites the rows of a lane that holds
    more than s_l - t (ROADMAP queue C); its one-hot ring store multiplies
    by the lane's activity."""
    if ring:
        return [sl % s_l if sl >= 0 else None for sl in slots]
    return [min(max(sl % s_l, 0), s_l - t) if sl >= 0 else None for sl in slots]


def _put(lane: torch.Tensor, rows: torch.Tensor, st: int) -> None:
    """Write rows [H, T, ...] into one lane [H, S, ...] from slot st; a run
    past the last slot wraps to slot 0 (only a ring's start lets it)."""
    t = rows.shape[1]
    n1 = min(t, lane.shape[1] - st)
    lane[:, st:st + n1] = rows[:, :n1]
    if n1 < t:
        lane[:, :t - n1] = rows[:, n1:]


def _store_cache(cache, new: torch.Tensor, starts: list) -> None:
    """Write ``new`` [B, Hkv, T, D] into ``cache`` in place at the per-lane
    start slots (``_layer_starts``; None skips the lane). A quantized
    ``(codes, scales)`` cache takes the rows quantized per (head, slot) and
    packed in its layout, and their scales written as computed: JAX's decode
    store blends the scale in (``sc + (s_new - sc) * onehot``), which can move
    it by an ulp."""
    if isinstance(cache, tuple):
        arr, sc = cache
        q, s_new = kv_codec.quantize_rows(new, kv_codec.kv_qmax(arr))   # [B, Hkv, T, D], [B, Hkv, T]
        q = kv_codec.pack_like(q, arr, sc)
        for lane, st in enumerate(starts):
            if st is not None:
                _put(arr[lane], q[lane], st)
                _put(sc[lane, :, 0], s_new[lane], st)
        return
    new = new.to(cache.dtype)
    for lane, st in enumerate(starts):
        if st is not None:
            _put(cache[lane], new[lane], st)


def attend(q, k_cache, v_cache, mask_positions, scale: float, window: int = 0,
           sinks=None, softcap: float = 0.0, ref: bool = False) -> torch.Tensor:
    """Attention over a bf16 cache, or over a quantized one by its layout:
    int8 codes take the q8 kernel, uint8 head-pair codes the q4hp kernel and
    halves-packed codes the q4 kernel. ``window`` > 0: the cache is a ring
    and each row sees its last ``window`` positions; ``sinks``: [H] logits
    that join only the softmax denominator; ``softcap`` > 0 caps the scores
    at +-softcap through tanh (gemma2). ``ref`` (``cfg.ref_attention``) takes
    the plain version on every device: the kernels have no backward."""
    opts = dict(softcap=softcap, window=window, sinks=sinks)
    if ref and isinstance(k_cache, tuple):
        return attention_kvq_ref(q, *k_cache, *v_cache, mask_positions, scale, **opts)
    if ref:
        return attention_ref(q, k_cache, v_cache, mask_positions, scale, **opts)
    if not isinstance(k_cache, tuple):
        return flash_attention(q, k_cache, v_cache, mask_positions, scale, **opts)
    if k_cache[0].dtype == torch.uint8:
        kern = flash_attention_q4hp if kv_codec.is_head_pair(*k_cache) else flash_attention_q4
    else:
        kern = flash_attention_q8
    return kern(q, *k_cache, *v_cache, mask_positions, scale, **opts)


def _capture(cap, li: int, name: str, x: torch.Tensor) -> None:
    """With a capture dict, record the per-input-channel sum of squares of a
    linear's input for imatrix collection (the JAX package's ``_capture``,
    IMatrixCollector::collect_imatrix analog); without one, nothing."""
    if cap is not None:
        x32 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        cap[f"blk.{li}.{name}"] = (x32 * x32).sum(0)
        cap.setdefault("__counts__", {})[f"blk.{li}.{name}"] = x32.shape[0]


def attention(cfg: ModelConfig, lw: LayerWeights, x: torch.Tensor,
              positions: torch.Tensor, k_cache, v_cache,
              mask_positions: torch.Tensor, slots: list[int], li: int = 0,
              cap=None, rope_factors=None) -> torch.Tensor:
    """One layer's attention; ``slots``: each lane's first cache slot (-1 =
    padded lane), from which the layer's own start slots follow;
    ``rope_factors``: LongRoPE's per-dimension frequency divisors."""
    b, t, _ = x.shape
    d = cfg.head_dim
    swa = cfg.is_swa(li)
    window = cfg.swa_window if swa else 0
    _capture(cap, li, "attn_q.weight", x)
    _capture(cap, li, "attn_k.weight", x)
    _capture(cap, li, "attn_v.weight", x)
    if lw.wqkv is not None:
        qkv = linear_apply(lw.wqkv, x)
        nq, nkv = cfg.n_q_dim, cfg.n_kv_dim
        qf, kf, vf = qkv[..., :nq], qkv[..., nq:nq + nkv], qkv[..., nq + nkv:]
    else:
        qf = linear_apply(lw.wq, x)
        kf = linear_apply(lw.wk, x)
        vf = linear_apply(lw.wv, x)
    if cfg.qk_norm_full:
        # olmo2: RMS over the whole projection, before the head reshape
        qf = rms_norm(qf, lw.q_norm, cfg.rms_eps)
        kf = rms_norm(kf, lw.k_norm, cfg.rms_eps)
    q = qf.reshape(b, t, cfg.n_heads, d)
    k = kf.reshape(b, t, cfg.n_kv_heads, d)
    v = vf.reshape(b, t, cfg.n_kv_heads, d)
    if cfg.qk_norm and not cfg.qk_norm_full:
        q = rms_norm(q, lw.q_norm, cfg.rms_eps)
        k = rms_norm(k, lw.k_norm, cfg.rms_eps)
    if not cfg.no_rope:                       # jamba's attention layers take none
        rp = rope_params(cfg, swa=swa)
        if cfg.rope_sections and positions.dim() == 3:
            # M-RoPE (qwen2vl): (t, h, w) channels; [B, T] positions of a
            # text-only step fall through to apply_rope, the same rotation
            q = apply_mrope(q, positions, rp, cfg.rope_sections)
            k = apply_mrope(k, positions, rp, cfg.rope_sections)
        else:
            q = apply_rope(q, positions, rp, freq_factors=rope_factors)
            k = apply_rope(k, positions, rp, freq_factors=rope_factors)
    s_l = (k_cache[0] if isinstance(k_cache, tuple) else k_cache).shape[2]
    starts = _layer_starts(slots, s_l, t, ring=window > 0)
    _store_cache(k_cache, k.transpose(1, 2), starts)
    _store_cache(v_cache, v.transpose(1, 2), starts)
    scale = cfg.attn_scale if cfg.attn_scale > 0 else 1.0 / np.sqrt(d)
    ctx = attend(q.contiguous(), k_cache, v_cache, mask_positions, scale, window=window,
                 sinks=lw.attn_sinks, softcap=cfg.attn_softcap, ref=cfg.ref_attention)
    ctx = ctx.reshape(b, t, cfg.n_heads * d).to(x.dtype)
    _capture(cap, li, "attn_output.weight", ctx)
    return linear_apply(lw.wo, ctx, reduce_axis=cfg.tp_axis)


def _mla_mm(eq: str, a: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """One of MLA's per-head products (the wk_b absorption, the wv_b
    decompression) in f32 on every device, rounded to ``dtype``."""
    return torch.einsum(eq, a.to(torch.float32), w.to(torch.float32)).to(dtype)


def mla_attend(q_full: torch.Tensor, k_cache, v_cache, mask_positions: torch.Tensor,
               scale: float) -> torch.Tensor:
    """MLA's attention proper, in plain f32 torch as the JAX package computes
    it in jnp: q_full [B, T, H, rope + r] against the one cached K row a
    position (a q8 / q4 cache dequantized whole), each row seeing the slots
    up to its mask position (-1: none, an all-zero row), the softmax, and
    the read-out of the cached c_kv rows. Returns [B, T, H, r] f32."""
    if isinstance(k_cache, tuple):
        kf = kv_codec.dequantize(*k_cache)[:, 0]                    # [B, S, rope + r] f32
        vf = kv_codec.dequantize(*v_cache)[:, 0]
    else:
        kf = k_cache[:, 0].to(torch.float32)
        vf = v_cache[:, 0].to(torch.float32)
    scores = torch.einsum("bthd,bsd->bhts", q_full.to(torch.float32), kf) * scale
    kv_pos = torch.arange(kf.shape[1], device=kf.device)
    mask = (kv_pos[None, None, :] <= mask_positions[:, :, None])[:, None]   # [B, 1, T, S]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, torch.zeros_like(probs))
    return torch.einsum("bhts,bsr->bthr", probs, vf)


def mla_attention(cfg: ModelConfig, lw: LayerWeights, x: torch.Tensor,
                  positions: torch.Tensor, k_cache, v_cache,
                  mask_positions: torch.Tensor, slots: list[int], li: int = 0,
                  cap=None, rope_factors=None) -> torch.Tensor:
    """Multi-head latent attention in the absorbed-MQA form of the JAX
    ``mla_attention``: the per-head nope query is absorbed through wk_b into
    the kv_lora_rank latent space, and attention runs as MQA over one cached
    row a position, [k_pe | c_kv] for K (the rope part first, so that a
    context shift re-rotates a leading slice) and c_kv for V; the value is
    read out through wv_b after the softmax. Over a q8 / q4 cache the rows
    are dequantized whole, as in the JAX package. The score / softmax /
    value products (``mla_attend``) are plain f32 torch (no kernel computes
    them in either package); the projections go through ``linear_apply``."""
    b, t, _ = x.shape
    h = cfg.n_heads
    rope_d, nope, r = cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.kv_lora_rank
    rp = mla_rope_params(cfg)
    if lw.wq_a is not None:
        _capture(cap, li, "attn_q_a.weight", x)
        ql = rms_norm(linear_apply(lw.wq_a, x), lw.q_norm, cfg.rms_eps)
        _capture(cap, li, "attn_q_b.weight", ql)
        q = linear_apply(lw.wq, ql)
    else:
        _capture(cap, li, "attn_q.weight", x)
        q = linear_apply(lw.wq, x)
    q = q.reshape(b, t, h, nope + rope_d)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    _capture(cap, li, "attn_kv_a_mqa.weight", x)
    kv = linear_apply(lw.wkv_a, x)                                  # [B, T, r + rope]
    c_kv = rms_norm(kv[..., :r], lw.k_norm, cfg.rms_eps)
    q_pe = apply_rope(q_pe, positions, rp)
    k_pe = apply_rope(kv[..., r:][:, :, None, :], positions, rp)[:, :, 0, :]
    q_abs = _mla_mm("bthn,hnr->bthr", q_nope, lw.wk_b, x.dtype)     # [B, T, H, r]
    q_full = torch.cat([q_pe, q_abs], dim=-1)                       # [B, T, H, rope + r]
    k_new = torch.cat([k_pe, c_kv], dim=-1)                         # [B, T, rope + r]
    s_l = (k_cache[0] if isinstance(k_cache, tuple) else k_cache).shape[2]
    starts = _layer_starts(slots, s_l, t, ring=False)
    _store_cache(k_cache, k_new[:, None], starts)
    _store_cache(v_cache, c_kv[:, None], starts)
    ctx = mla_attend(q_full, k_cache, v_cache, mask_positions, mla_kq_scale(cfg))
    out_v = _mla_mm("bthr,hrv->bthv", ctx, lw.wv_b, x.dtype).reshape(b, t, h * cfg.v_head_dim)
    _capture(cap, li, "attn_output.weight", out_v)
    return linear_apply(lw.wo, out_v, reduce_axis=cfg.tp_axis)


def ffn(cfg: ModelConfig, lw: LayerWeights, x: torch.Tensor, cap=None,
        li: int = 0) -> torch.Tensor:
    if lw.moe is not None:
        return moe_ffn(cfg, lw.moe, x)
    _capture(cap, li, "ffn_gate.weight", x)
    _capture(cap, li, "ffn_up.weight", x)
    if lw.w_gateup is not None:
        gu = linear_apply(lw.w_gateup, x)
        gate, up = gu[..., : cfg.n_ff], gu[..., cfg.n_ff:]
    else:
        gate = linear_apply(lw.w_gate, x)
        up = linear_apply(lw.w_up, x)
    act_fn = gelu_tanh if cfg.ffn_act == "gelu" else torch.nn.functional.silu
    act = act_fn(gate.to(torch.float32)).to(x.dtype) * up
    _capture(cap, li, "ffn_down.weight", act)
    return linear_apply(lw.w_down, act, reduce_axis=cfg.tp_axis)


def forward(cfg: ModelConfig, w: ModelWeights, tokens, positions, k_caches: list,
            v_caches: list, mask_positions, cache_slots, last_idx=None,
            slots: Optional[list] = None, cap=None, control_vector=None,
            embeds=None) -> torch.Tensor:
    """One decode/prefill step; returns logits [B, T, V] f32 (or [B, 1, V]
    with ``last_idx``). The index inputs ([B, T] int tokens, positions,
    mask positions (-1 = padded row) and cache slots) may live on the host:
    the K/V store reads each lane's first slot there, and the rest is copied
    to the weights' device. A caller whose indices already live on the device
    passes those first ``slots`` (host ints, -1 for a padded lane) instead,
    so that nothing is read back; each layer takes its start slots from them
    (modulo its ring). The caches are updated in place. ``cap``, a dict,
    receives each linear's input sums of squares (``_capture``), and with a
    ``"__hidden__"`` dict in it each layer's mean output row in f32 (the
    cvector tool's collection); ``control_vector`` (``models.adapter.
    ControlVector``) is added to the residual after each layer's FFN.
    ``embeds`` [B, T, E] replaces the token embedding (image chunks; no
    ``embd_scale``, which scales token embeddings only); ``positions`` of
    rank 3 ([B, T, C]) are M-RoPE channels for a model with
    ``rope_sections``."""
    dev = w.device
    tokens = torch.as_tensor(tokens).to(dev)
    positions = torch.as_tensor(positions).to(dev)
    if slots is None:
        slots = _lane_slots(cache_slots, mask_positions)
    mask_dev = torch.as_tensor(mask_positions).to(dev)
    x = embed_tokens(cfg, w, tokens) if embeds is None else torch.as_tensor(embeds).to(dev)
    for li, lw in enumerate(w.layers):
        x = layer(cfg, w, lw, x, positions, k_caches[li], v_caches[li], mask_dev, slots, li,
                  cap=cap)
        if control_vector is not None:
            x = control_vector.apply(x, li)
        if cap is not None and "__hidden__" in cap:
            cap["__hidden__"][li] = x.reshape(-1, x.shape[-1]).to(torch.float32).mean(0)
    if last_idx is not None:
        idx = torch.as_tensor(last_idx).to(dev).clamp_min(0).to(torch.int64)
        x = torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[-1]))
    x = rms_norm(x, w.final_norm, cfg.rms_eps)
    logits = linear_apply(w.lm_head, x).to(torch.float32)
    if cfg.logits_divisor != 1.0:
        logits = logits / cfg.logits_divisor
    if cfg.final_softcap > 0:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def embed_tokens(cfg: ModelConfig, w: ModelWeights, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings, times ``embd_scale`` (gemma's sqrt(E), granite,
    minicpm) in f32 and rounded back."""
    x = embed_rows(w.embed, tokens)
    if cfg.embd_scale != 1.0:
        x = (x.to(torch.float32) * cfg.embd_scale).to(x.dtype)
    return x


def layer(cfg: ModelConfig, w: ModelWeights, lw: LayerWeights, x: torch.Tensor, positions,
          k_cache, v_cache, mask_positions, slots: list[int], li: int, cap=None) -> torch.Tensor:
    """One transformer block of the JAX ``forward``: pre-norms (none under
    ``post_norm_only``), attention (MLA for deepseek2), the sandwich norms
    where the layer has them, ``residual_scale`` on each branch, FFN."""
    attn_fn = mla_attention if cfg.is_mla else attention
    h = x if cfg.post_norm_only else rms_norm(x, lw.attn_norm, cfg.rms_eps)
    a = attn_fn(cfg, lw, h, positions, k_cache, v_cache, mask_positions, slots, li, cap=cap,
                rope_factors=w.rope_factors)
    if lw.attn_post_norm is not None:
        a = rms_norm(a, lw.attn_post_norm, cfg.rms_eps)
    if cfg.residual_scale != 1.0:
        a = a * cfg.residual_scale
    x = x + a
    h = x if cfg.post_norm_only else rms_norm(x, lw.ffn_norm, cfg.rms_eps)
    f = ffn(cfg, lw, h, cap=cap, li=li)
    if lw.ffn_post_norm is not None:
        f = rms_norm(f, lw.ffn_post_norm, cfg.rms_eps)
    if cfg.residual_scale != 1.0:
        f = f * cfg.residual_scale
    return x + f


def scratch_caches(cfg: ModelConfig, b: int, t: int, dtype=torch.bfloat16, device="cpu"):
    """Throwaway zero K/V caches per layer for one forward of T tokens (tools
    that run a stateless forward; rrs_tpu/models/llama.py:529), in the
    cache geometry of ``cfg`` (MLA: one head, K and V of other widths)."""
    h = cfg.kv_cache_heads
    ks = [torch.zeros((b, h, t, cfg.kv_k_dim), dtype=dtype, device=device)
          for _ in range(cfg.n_layers)]
    vs = [torch.zeros((b, h, t, cfg.kv_v_dim), dtype=dtype, device=device)
          for _ in range(cfg.n_layers)]
    return ks, vs


@torch.inference_mode()
def decode_scan(cfg: ModelConfig, w: ModelWeights, first_token, start_pos, k_caches: list,
                v_caches: list, n_steps: int, logits_fixup=None):
    """Greedy-decode n_steps tokens on the device, the twin of the JAX
    ``decode_scan`` (rrs_tpu/models/llama.py:547): step i feeds each lane's
    token at position start_pos + i and takes the argmax. ``first_token``:
    [B] ints (host or device); ``start_pos``: [B] host ints. Each step's slot
    is clip(pos, 0, s - 1) over the largest cache (ring layers wrap it modulo
    their own size). The positions are uploaded once and the tokens stay on
    the device, so nothing is read back. Returns (tokens [B, n_steps], the
    tokens fed, first_token first; last, the final argmax [B]; and the caches,
    updated in place)."""
    dev = w.device
    s = max((c[0] if isinstance(c, tuple) else c).shape[2] for c in k_caches)
    start = np.asarray(start_pos, np.int64).reshape(-1)
    pos = start[None, :] + np.arange(n_steps, dtype=np.int64)[:, None]      # [n, B]
    slots = np.clip(pos, 0, s - 1)
    pos_t = torch.from_numpy(pos.astype(np.int32))
    pos_dev = pos_t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else pos_t
    token = torch.as_tensor(first_token).to(device=dev, dtype=torch.int64).reshape(-1)
    toks = []
    for i in range(n_steps):
        pcol = pos_dev[i][:, None]
        logits = forward(cfg, w, token[:, None], pcol, k_caches, v_caches, pcol, None,
                         slots=slots[i].tolist())
        if logits_fixup is not None:
            logits = logits_fixup(logits)
        toks.append(token)
        token = torch.argmax(logits[:, 0, :], dim=-1)
    return torch.stack(toks, dim=1), token, k_caches, v_caches


# ---------------------------------------------------------------------------
# Weight builders
# ---------------------------------------------------------------------------

def random_weights(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                   quantize: bool = False, scale: float = 0.02,
                   device="cpu") -> ModelWeights:
    """Random weights from a NumPy generator (the draw order of the JAX
    ``random_weights``: an MoE layer draws its router and dense expert
    stacks first), the linears optionally TCQ4-quantized on the host; tied
    dense lm_head."""
    from rrs_tpu_torch.formats.tcq4 import quantize_tcq4

    rng = np.random.default_rng(seed)

    def tens(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device=device, dtype=dt)

    def lin(k, n):
        if not quantize or k % 256 or n % 8:
            return DenseLinear(w=tens(rng.standard_normal((k, n)) * scale))
        wm = (rng.standard_normal((n, k)) * scale).astype(np.float32)
        return TCQ4Linear.from_tensor(quantize_tcq4(wm), device=device)

    e, hq, hkv, d, f = cfg.n_embd, cfg.n_q_dim, cfg.n_kv_dim, cfg.head_dim, cfg.n_ff
    ones = lambda n: torch.ones((n,), dtype=dtype, device=device)   # noqa: E731
    layers = []
    for _ in range(cfg.n_layers):
        moe = None
        if cfg.n_experts > 0:
            fe, n_exp = cfg.n_ff_exp or f, cfg.n_experts
            moe = MoEWeights(router=tens(rng.standard_normal((e, n_exp)) * scale),
                             gate=tens(rng.standard_normal((n_exp, e, fe)) * scale),
                             up=tens(rng.standard_normal((n_exp, e, fe)) * scale),
                             down=tens(rng.standard_normal((n_exp, fe, e)) * scale))
        wq, wk, wv, wo = lin(e, hq), lin(e, hkv), lin(e, hkv), lin(hq, e)
        layers.append(LayerWeights(
            attn_norm=ones(e), wq=wq, wk=wk, wv=wv, wo=wo,
            q_norm=ones(d) if cfg.qk_norm else None,
            k_norm=ones(d) if cfg.qk_norm else None,
            ffn_norm=ones(e),
            w_gate=lin(e, f) if moe is None else None,
            w_up=lin(e, f) if moe is None else None,
            w_down=lin(f, e) if moe is None else None,
            moe=moe,
            attn_post_norm=ones(e) if cfg.sandwich_norm else None,
            ffn_post_norm=ones(e) if cfg.sandwich_norm else None,
        ))
    embed = tens(rng.standard_normal((cfg.vocab_size, e)) * scale)
    return ModelWeights(embed=embed, layers=layers, final_norm=ones(e),
                        lm_head=DenseLinear(w=embed.t()))


def fabricated_tcq4_weights(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                            device=None) -> ModelWeights:
    """Structurally valid random TCQ4 weights drawn directly (no quantizer),
    on the device from a seeded ``torch.Generator``: fused qkv and gate-up
    projections (q / k norms and gemma's sandwich norms as ones where the
    config has them) with uniform qs bytes and bf16
    eff in [0.001, 0.011), each with its i8p pack unless ``RRS_PREFILL_I8=0``
    (as the JAX package packs them, at their fused widths), a Q8 lm_head padded
    by ``n_pad_width`` with f32 scales in [0, 0.001). For throughput runs,
    where the compute cost is what matters and the weight values are not."""
    from rrs_tpu_torch.device import resolve_device

    from rrs_tpu_torch.ops.tcq4_matmul import pack_i8p

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    packed = want_i8p()

    def qlin(k, n):
        qs = torch.randint(0, 256, (k // 2, n), generator=gen, device=dev, dtype=torch.uint8)
        eff = (torch.rand((k // 32, n), generator=gen, device=dev) * 0.01 + 0.001
               ).to(torch.bfloat16)
        return TCQ4Linear(qs=qs, eff=eff, i8p=pack_i8p(qs, eff) if packed else None)

    e, hq, hkv, d, f = cfg.n_embd, cfg.n_q_dim, cfg.n_kv_dim, cfg.head_dim, cfg.n_ff
    ones = lambda n: torch.ones((n,), dtype=dtype, device=dev)   # noqa: E731
    layers = []
    for _ in range(cfg.n_layers):
        norms = dict(attn_norm=ones(e), ffn_norm=ones(e),
                     q_norm=ones(d) if cfg.qk_norm else None,
                     k_norm=ones(d) if cfg.qk_norm else None,
                     attn_post_norm=ones(e) if cfg.sandwich_norm else None,
                     ffn_post_norm=ones(e) if cfg.sandwich_norm else None)
        layers.append(LayerWeights(
            wq=None, wk=None, wv=None, wo=qlin(hq, e),
            w_gate=None, w_up=None, w_down=qlin(f, e),
            wqkv=qlin(e, hq + 2 * hkv), w_gateup=qlin(e, 2 * f), **norms))
    embed = (torch.randn((cfg.vocab_size, e), generator=gen, device=dev) * 0.02).to(dtype)
    n_pad = n_pad_width(cfg.vocab_size)
    lm_q = torch.randint(-127, 128, (e, n_pad), generator=gen, device=dev, dtype=torch.int8)
    lm_s = torch.rand((e // 32, n_pad), generator=gen, device=dev) * 1e-3
    return ModelWeights(embed=embed, layers=layers, final_norm=ones(e),
                        lm_head=Q8Linear(q=lm_q, scale=lm_s, n_logical=cfg.vocab_size))


def _columns(lin, a: int, b: int):
    """Columns [a, b) of a linear, contiguous (every array of each type is
    per-column: codes, scales, the i8p pack, the bias)."""
    cut = lambda t: None if t is None else t[..., a:b].contiguous()   # noqa: E731
    if isinstance(lin, DenseLinear):
        return DenseLinear(w=cut(lin.w), bias=cut(lin.bias))
    if isinstance(lin, TCQ4Linear):
        return TCQ4Linear(qs=cut(lin.qs), eff=cut(lin.eff), gather=lin.gather, bias=cut(lin.bias),
                          i8p=None if lin.i8p is None else tuple(cut(x) for x in lin.i8p))
    if isinstance(lin, Q8Linear):
        return Q8Linear(q=cut(lin.q), scale=cut(lin.scale), bias=cut(lin.bias),
                        k_logical=lin.k_logical)
    if isinstance(lin, MXFP4Linear):
        return MXFP4Linear(qs=cut(lin.qs), scale=cut(lin.scale), bias=cut(lin.bias))
    raise TypeError(f"cannot split a {type(lin).__name__}")


def unfused(cfg: ModelConfig, w: ModelWeights) -> ModelWeights:
    """The weights with each fused qkv / gate-up linear split back into q, k,
    v and gate, up (copies of its column ranges), as a tensor-parallel mesh
    needs them; the same products, column for column."""
    layers = []
    for lw in w.layers:
        upd = {}
        if lw.wqkv is not None:
            nq, nkv = cfg.n_q_dim, cfg.n_kv_dim
            upd.update(wqkv=None, wq=_columns(lw.wqkv, 0, nq),
                       wk=_columns(lw.wqkv, nq, nq + nkv),
                       wv=_columns(lw.wqkv, nq + nkv, nq + 2 * nkv))
        if lw.w_gateup is not None:
            upd.update(w_gateup=None, w_gate=_columns(lw.w_gateup, 0, cfg.n_ff),
                       w_up=_columns(lw.w_gateup, cfg.n_ff, 2 * cfg.n_ff))
        layers.append(dataclasses.replace(lw, **upd))
    return dataclasses.replace(w, layers=layers)


def fabricated_mla_weights(cfg: ModelConfig, seed: int = 0, device=None,
                           quantized: bool = True) -> ModelWeights:
    """deepseek2 (MLA) weights drawn on the device from a seeded
    ``torch.Generator``, in the types the repository's quantizer and loader
    give a deepseek2 GGUF: each 2-D projection TCQ4 (uniform qs bytes, bf16
    eff in [0.001, 0.011), with its i8p pack unless ``RRS_PREFILL_I8=0``) where
    K % 256 == 0 and N % 8 == 0, else Q8_0 with K padded to 256 (the lead
    layers' ffn_down at K = 10,944), unfused as the loader keeps MLA layers;
    wk_b [H, nope, r] and wv_b [H, r, v] bf16 N(0, 0.02); the first
    ``n_dense_lead`` layers a dense FFN, the others a router N(0, 0.05) in
    bf16 (with a selection bias N(0, 0.1) under sigmoid gating), dense bf16
    expert stacks N(0, 0.02) (n_ff_exp = 1,408 is not TCQ4-eligible) and a
    dense bf16 shared expert of two experts' width; the norms ones; a bf16
    embedding N(0, 0.02) and a Q8_0 lm_head padded by ``n_pad_width``.
    ``quantized=False`` draws every projection as a bf16 DenseLinear N(0,
    0.05) instead (the card-vs-CPU glue checks)."""
    from rrs_tpu_torch.device import resolve_device
    from rrs_tpu_torch.ops.tcq4_matmul import pack_i8p

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    packed = want_i8p()

    def normal(scl, shape, dt=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scl).to(dt)

    def q8lin(k, n):
        npad, kpad = n_pad_width(n), -(-k // 256) * 256
        q = torch.randint(-127, 128, (kpad, npad), generator=gen, device=dev, dtype=torch.int8)
        sc = torch.rand((kpad // 32, npad), generator=gen, device=dev) * 1e-3
        if kpad != k:
            sc[k // 32:] = 0.0
        return Q8Linear(q=q, scale=sc, n_logical=n, k_logical=k if kpad != k else 0)

    def lin(k, n):
        if not quantized:
            return DenseLinear(w=normal(0.05, (k, n)))
        if k % 256 or n % 8:
            return q8lin(k, n)
        qs = torch.randint(0, 256, (k // 2, n), generator=gen, device=dev, dtype=torch.uint8)
        eff = (torch.rand((k // 32, n), generator=gen, device=dev) * 0.01 + 0.001
               ).to(torch.bfloat16)
        return TCQ4Linear(qs=qs, eff=eff, i8p=pack_i8p(qs, eff) if packed else None)

    e, h, r = cfg.n_embd, cfg.n_heads, cfg.kv_lora_rank
    ones = lambda n: torch.ones((n,), dtype=torch.bfloat16, device=dev)   # noqa: E731
    layers = []
    for li in range(cfg.n_layers):
        attn = dict(attn_norm=ones(e), ffn_norm=ones(e), wk=None, wv=None,
                    wkv_a=lin(e, r + cfg.qk_rope_dim), k_norm=ones(r),
                    wk_b=normal(0.02, (h, cfg.qk_nope_dim, r)),
                    wv_b=normal(0.02, (h, r, cfg.v_head_dim)),
                    wo=lin(h * cfg.v_head_dim, e))
        if cfg.q_lora_rank:
            attn.update(wq_a=lin(e, cfg.q_lora_rank), q_norm=ones(cfg.q_lora_rank),
                        wq=lin(cfg.q_lora_rank, h * cfg.head_dim))
        else:
            attn.update(q_norm=None, wq=lin(e, h * cfg.head_dim))
        if li < cfg.n_dense_lead or not cfg.n_experts:
            layers.append(LayerWeights(w_gate=lin(e, cfg.n_ff), w_up=lin(e, cfg.n_ff),
                                       w_down=lin(cfg.n_ff, e), **attn))
            continue
        n_exp, fe = cfg.n_experts, cfg.n_ff_exp
        moe = MoEWeights(router=normal(0.05, (e, n_exp)),
                         gate=normal(0.02, (n_exp, e, fe)), up=normal(0.02, (n_exp, e, fe)),
                         down=normal(0.02, (n_exp, fe, e)),
                         probs_bias=None if cfg.expert_gating_softmax
                         else normal(0.1, (n_exp,), torch.float32),
                         shared_gate=normal(0.02, (e, 2 * fe)),
                         shared_up=normal(0.02, (e, 2 * fe)),
                         shared_down=normal(0.02, (2 * fe, e)))
        layers.append(LayerWeights(w_gate=None, w_up=None, w_down=None, moe=moe, **attn))
    embed = normal(0.02, (cfg.vocab_size, e))
    lm_head = DenseLinear(w=normal(0.05, (e, cfg.vocab_size))) if not quantized \
        else q8lin(e, cfg.vocab_size)
    return ModelWeights(embed=embed, layers=layers, final_norm=ones(e), lm_head=lm_head)


def fabricated_gptoss_weights(cfg: ModelConfig, seed: int = 0, device=None) -> ModelWeights:
    """gpt-oss weights drawn on the device from a seeded ``torch.Generator``,
    with the recipe of benchmarks/bench_gptoss.py: MXFP4 expert stacks
    (uniform code bytes, sexp in [118, 122], i.e. half block scales
    2^-9 .. 2^-5) with N padded to 128; Q8_0 attention and lm_head with
    power-of-two scales 2^-11 .. 2^-10 and K padded to 256 (2880 -> 3072);
    a Q8-packed embedding table; router N(0, 0.05) in bf16 with a zero bias;
    expert, qkv and output biases N(0, 0.01); per-head sinks N(0, 1). Fused
    qkv (q / k / v carry no N pad); the lm_head pads N as the loader does.
    For runs where the compute and the traffic matter and the values do not."""
    from rrs_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    e, f, n_exp = cfg.n_embd, cfg.n_ff_exp, cfg.n_experts

    def normal(scl, shape):
        return torch.randn(shape, generator=gen, device=dev) * scl

    def pow2(lo, hi, shape):
        return 2.0 ** torch.randint(lo, hi, shape, generator=gen, device=dev).to(torch.float32)

    def mxstack(k, n):
        npad = -(-n // 128) * 128
        return (torch.randint(0, 256, (n_exp, k // 2, npad), generator=gen, device=dev,
                              dtype=torch.uint8),
                torch.randint(118, 123, (n_exp, k // 32, npad), generator=gen, device=dev,
                              dtype=torch.uint8))

    def q8lin(k, n, bias=False):
        npad, kpad = n_pad_width(n), -(-k // 256) * 256
        q = torch.randint(-127, 128, (kpad, npad), generator=gen, device=dev, dtype=torch.int8)
        return Q8Linear(q=q, scale=pow2(-11, -9, (kpad // 32, npad)),
                        bias=normal(1e-2, (n,)) if bias else None, n_logical=n,
                        k_logical=k if kpad != k else 0)

    ones = lambda n: torch.ones((n,), dtype=torch.bfloat16, device=dev)   # noqa: E731
    layers = []
    for _ in range(cfg.n_layers):
        gq, ge = mxstack(e, f)
        uq, ue = mxstack(e, f)
        dq, de = mxstack(f, e)
        moe = MoEWeights(router=normal(0.05, (e, n_exp)).to(torch.bfloat16), quant_kind="mxfp4",
                         gate_qs=gq, gate_eff=ge, up_qs=uq, up_eff=ue, down_qs=dq, down_eff=de,
                         router_bias=torch.zeros((n_exp,), device=dev),
                         gate_b=normal(1e-2, (n_exp, f)), up_b=normal(1e-2, (n_exp, f)),
                         down_b=normal(1e-2, (n_exp, e)))
        layers.append(LayerWeights(
            attn_norm=ones(e), wq=None, wk=None, wv=None,
            wqkv=q8lin(e, cfg.n_q_dim + 2 * cfg.n_kv_dim, bias=True),
            wo=q8lin(cfg.n_q_dim, e, bias=True), q_norm=None, k_norm=None,
            attn_sinks=normal(1.0, (cfg.n_heads,)), ffn_norm=ones(e),
            w_gate=None, w_up=None, w_down=None, moe=moe))
    embed = (torch.randint(-127, 128, (cfg.vocab_size, e), generator=gen, device=dev,
                           dtype=torch.int8),
             pow2(-11, -9, (cfg.vocab_size, e // 32)))
    return ModelWeights(embed=embed, layers=layers, final_norm=ones(e),
                        lm_head=q8lin(e, cfg.vocab_size))


def fabricated_tcq4_moe_weights(cfg: ModelConfig, seed: int = 0, device=None) -> ModelWeights:
    """qwen3moe weights drawn on the device from a seeded ``torch.Generator``,
    with the recipe of benchmarks/bench_moe.py: TCQ4 expert stacks (uniform
    qs bytes, bf16 eff in [0.001, 0.011)), a router N(0, 0.05) in bf16, and
    per layer a fused TCQ4 qkv and an o projection (each with its i8p pack
    unless ``RRS_PREFILL_I8=0``, as ``fabricated_tcq4_weights`` draws them),
    q / k norms, a bf16 embedding N(0, 0.02) and an untied Q8 lm_head padded
    by ``n_pad_width`` with f32 scales in [0, 0.001). Both expert dims must
    be multiples of 256. For runs where the compute and the traffic matter
    and the values do not."""
    from rrs_tpu_torch.device import resolve_device
    from rrs_tpu_torch.ops.tcq4_matmul import pack_i8p

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    packed = want_i8p()
    e, f, n_exp = cfg.n_embd, cfg.n_ff_exp, cfg.n_experts

    def qs_eff(lead, k, n):
        qs = torch.randint(0, 256, (*lead, k // 2, n), generator=gen, device=dev,
                           dtype=torch.uint8)
        eff = (torch.rand((*lead, k // 32, n), generator=gen, device=dev) * 0.01 + 0.001
               ).to(torch.bfloat16)
        return qs, eff

    def qlin(k, n):
        qs, eff = qs_eff((), k, n)
        return TCQ4Linear(qs=qs, eff=eff, i8p=pack_i8p(qs, eff) if packed else None)

    ones = lambda n: torch.ones((n,), dtype=torch.bfloat16, device=dev)   # noqa: E731
    layers = []
    for _ in range(cfg.n_layers):
        gq, ge = qs_eff((n_exp,), e, f)
        uq, ue = qs_eff((n_exp,), e, f)
        dq, de = qs_eff((n_exp,), f, e)
        router = (torch.randn((e, n_exp), generator=gen, device=dev) * 0.05).to(torch.bfloat16)
        moe = MoEWeights(router=router, gate_qs=gq, gate_eff=ge, up_qs=uq, up_eff=ue,
                         down_qs=dq, down_eff=de, quant_kind="tcq4")
        layers.append(LayerWeights(
            attn_norm=ones(e), ffn_norm=ones(e), wq=None, wk=None, wv=None,
            wqkv=qlin(e, cfg.n_q_dim + 2 * cfg.n_kv_dim), wo=qlin(cfg.n_q_dim, e),
            q_norm=ones(cfg.head_dim), k_norm=ones(cfg.head_dim),
            w_gate=None, w_up=None, w_down=None, moe=moe))
    embed = (torch.randn((cfg.vocab_size, e), generator=gen, device=dev) * 0.02
             ).to(torch.bfloat16)
    n_pad = n_pad_width(cfg.vocab_size)
    lm_q = torch.randint(-127, 128, (e, n_pad), generator=gen, device=dev, dtype=torch.int8)
    lm_s = torch.rand((e // 32, n_pad), generator=gen, device=dev) * 1e-3
    return ModelWeights(embed=embed, layers=layers, final_norm=ones(e),
                        lm_head=Q8Linear(q=lm_q, scale=lm_s, n_logical=cfg.vocab_size))


def to_device(obj, device):
    """A copy of a weights tree (dataclasses, lists, tuples and dicts of
    tensors) on ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device) for f in dataclasses.fields(obj)})
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(o, device) for o in obj)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    return obj


def _tensor(a, device, dtype=None) -> Optional[torch.Tensor]:
    """NumPy -> torch; a bfloat16 array (as JAX hands them out) is moved
    bit for bit through its uint16 view."""
    if a is None:
        return None
    a = np.array(a, order="C")          # a writable copy (JAX hands out read-only views)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def _linear_from_numpy(d, device):
    if d is None:
        return None
    if "base" in d:                          # a LoRA-wrapped linear
        return LoraLinear(base=_linear_from_numpy(d["base"], device),
                          a=_tensor(d["a"], device, torch.bfloat16),
                          b=_tensor(d["b"], device, torch.bfloat16), scale=float(d["scale"]))
    bias = _tensor(d.get("bias"), device)
    if "qs" in d and "scale" in d:
        return MXFP4Linear(qs=_tensor(d["qs"], device), scale=_tensor(d["scale"], device),
                           bias=bias, n_logical=int(d.get("n_logical", 0) or 0))
    if "qs" in d:
        gather = d.get("gather")
        i8p = d.get("i8p")
        if i8p is not None:
            i8p = (_tensor(i8p[0], device), _tensor(i8p[1], device),
                   _tensor(i8p[2], device, torch.float32))
        return TCQ4Linear(
            qs=_tensor(d["qs"], device), eff=_tensor(d["eff"], device, torch.bfloat16),
            gather=None if gather is None else _tensor(gather, device, torch.int64),
            bias=bias, i8p=i8p)
    if "q" in d:
        return Q8Linear(q=_tensor(d["q"], device), scale=_tensor(d["scale"], device),
                        bias=bias, n_logical=int(d.get("n_logical", 0) or 0),
                        k_logical=int(d.get("k_logical", 0) or 0))
    if "w" in d:
        return DenseLinear(w=_tensor(d["w"], device), bias=bias)
    raise NotImplementedError(f"linear layer with fields {sorted(d)} is not ported")


_LAYER_LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "wqkv", "w_gateup",
                  "wq_a", "wkv_a")
_LAYER_TENSORS = ("attn_norm", "q_norm", "k_norm", "ffn_norm", "attn_sinks", "attn_post_norm",
                  "ffn_post_norm", "wk_b", "wv_b")
_MOE_TENSORS = ("router", "gate", "up", "down", "gate_qs", "gate_eff", "up_qs", "up_eff",
                "down_qs", "down_eff", "probs_bias", "router_bias", "gate_b", "up_b", "down_b",
                "shared_gate", "shared_up", "shared_down")


def _moe_from_numpy(d, device) -> Optional[MoEWeights]:
    """The JAX MoEWeights fields -> the port's: MXFP4, TCQ4 or dense bf16
    stacks and the dense shared expert (bfloat16 arrays move bit for bit)."""
    if d is None:
        return None
    kind = str(np.asarray(d.get("quant_kind", "tcq4")))
    return MoEWeights(quant_kind=kind, **{k: _tensor(d.get(k), device) for k in _MOE_TENSORS})


def weights_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> ModelWeights:
    """Build the port's weights from the JAX package's parameters, given as a
    plain nested dict of NumPy arrays keyed by the JAX dataclass field names:
    ``embed`` (an array, or a (q, scale) pair), ``final_norm``, ``lm_head``
    and ``layers[i]`` with ``attn_norm``, ``wqkv`` ({qs, eff, gather, bias}),
    ``lm_head`` ({q, scale, n_logical, k_logical} or {w, bias}), an MXFP4
    linear ({qs, scale, bias, n_logical}), ``attn_sinks``, ``moe`` (the
    MoEWeights fields: MXFP4, TCQ4 or dense stacks, and a shared expert) and
    so on, MLA's ``wq_a`` / ``wkv_a`` linears and ``wk_b`` / ``wv_b`` factors,
    the sandwich norms ``attn_post_norm`` / ``ffn_post_norm``, and at the top
    ``rope_factors`` (LongRoPE); a TCQ4 linear's ``i8p`` is its (qs_sbi, f8,
    e2) pack or None; a LoRA-wrapped linear is {base, a, b, scale}. A field
    the port does not know raises."""
    from rrs_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    layers = []
    for ld in tree["layers"]:
        extra = [k for k, v in ld.items()
                 if v is not None and k not in _LAYER_LINEARS + _LAYER_TENSORS + ("moe",)]
        if extra:
            raise NotImplementedError(f"layer fields {extra} are not ported to rrs_tpu_torch")
        layers.append(LayerWeights(
            **{k: _tensor(ld.get(k), dev) for k in _LAYER_TENSORS},
            **{k: _linear_from_numpy(ld.get(k), dev) for k in _LAYER_LINEARS},
            moe=_moe_from_numpy(ld.get("moe"), dev)))
    emb = tree["embed"]
    if isinstance(emb, (tuple, list)):
        embed = (_tensor(emb[0], dev), _tensor(emb[1], dev))
    else:
        embed = _tensor(emb, dev)
    return ModelWeights(embed=embed, layers=layers,
                        final_norm=_tensor(tree["final_norm"], dev),
                        lm_head=_linear_from_numpy(tree["lm_head"], dev),
                        rope_factors=_tensor(tree.get("rope_factors"), dev, torch.float32))
