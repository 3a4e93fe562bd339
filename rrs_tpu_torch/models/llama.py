"""Dense llama-family transformer forward (Llama 3, Qwen2.5, Qwen3).

Port of the dense path of ``rrs_tpu/models/llama.py``: RMSNorm -> QKV
(+ per-head q/k norm) -> RoPE -> KV store -> GQA flash attention -> output
projection -> RMSNorm -> SwiGLU FFN, then the final norm and the lm_head.

Weights are plain dataclasses of tensors. Where the JAX forward returns new
caches, this one writes the new K/V rows into the preallocated
[B, Hkv, S, D] caches in place and returns only the logits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.models.linear import (
    DenseLinear,
    Q8Linear,
    TCQ4Linear,
    linear_apply,
    n_pad_width,
)
from rrs_tpu_torch.ops.basic import RopeParams, apply_rope, rms_norm
from rrs_tpu_torch.ops.flash_attention import flash_attention


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


@dataclasses.dataclass
class ModelWeights:
    # [vocab, n_embd] bf16, or a Q8_0-packed (q int8 [V, E], scale [V, E//32])
    # pair whose rows are dequantized per looked-up token
    embed: Any
    layers: list
    final_norm: torch.Tensor
    lm_head: Any

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


def rope_params(cfg: ModelConfig) -> RopeParams:
    return RopeParams(
        head_dim=cfg.head_dim,
        theta=cfg.rope_theta,
        scaling_type=cfg.rope_scaling_type,
        scale_factor=cfg.rope_scale_factor,
        orig_context=cfg.rope_orig_context,
        neox=cfg.rope_neox,
    )


def _store_starts(cache_slots, mask_positions, s_l: int, t: int) -> list[int]:
    """First cache slot each lane writes: its own slot, or s_l - t for a
    padded lane (mask -1), which parks its rows at the top of the cache where
    any sequence reaching them rewrites them before attending. The start is
    clamped to [0, s_l - t] like the JAX dynamic_update_slice."""
    slots = torch.as_tensor(cache_slots).reshape(len(cache_slots), -1)[:, 0].tolist()
    masks = torch.as_tensor(mask_positions).reshape(len(mask_positions), -1)[:, 0].tolist()
    return [min(max(sl % s_l if mk >= 0 else s_l - t, 0), s_l - t)
            for sl, mk in zip(slots, masks)]


def _store_cache(cache: torch.Tensor, new: torch.Tensor, starts: list[int]) -> None:
    """Write ``new`` [B, Hkv, T, D] into ``cache`` [B, Hkv, S, D] in place at
    the per-lane start slots (a contiguous run per lane)."""
    t = new.shape[2]
    new = new.to(cache.dtype)
    for lane, st in enumerate(starts):
        cache[lane, :, st:st + t] = new[lane]


def attention(cfg: ModelConfig, lw: LayerWeights, x: torch.Tensor,
              positions: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
              mask_positions: torch.Tensor, starts: list[int]) -> torch.Tensor:
    b, t, _ = x.shape
    d = cfg.head_dim
    if lw.wqkv is not None:
        qkv = linear_apply(lw.wqkv, x)
        nq, nkv = cfg.n_q_dim, cfg.n_kv_dim
        qf, kf, vf = qkv[..., :nq], qkv[..., nq:nq + nkv], qkv[..., nq + nkv:]
    else:
        qf = linear_apply(lw.wq, x)
        kf = linear_apply(lw.wk, x)
        vf = linear_apply(lw.wv, x)
    q = qf.reshape(b, t, cfg.n_heads, d)
    k = kf.reshape(b, t, cfg.n_kv_heads, d)
    v = vf.reshape(b, t, cfg.n_kv_heads, d)
    if cfg.qk_norm:
        q = rms_norm(q, lw.q_norm, cfg.rms_eps)
        k = rms_norm(k, lw.k_norm, cfg.rms_eps)
    rp = rope_params(cfg)
    q = apply_rope(q, positions, rp)
    k = apply_rope(k, positions, rp)
    _store_cache(k_cache, k.transpose(1, 2), starts)
    _store_cache(v_cache, v.transpose(1, 2), starts)
    scale = 1.0 / np.sqrt(d)
    ctx = flash_attention(q.contiguous(), k_cache, v_cache, mask_positions, scale)
    ctx = ctx.reshape(b, t, cfg.n_heads * d).to(x.dtype)
    return linear_apply(lw.wo, ctx)


def ffn(cfg: ModelConfig, lw: LayerWeights, x: torch.Tensor) -> torch.Tensor:
    if lw.w_gateup is not None:
        gu = linear_apply(lw.w_gateup, x)
        gate, up = gu[..., : cfg.n_ff], gu[..., cfg.n_ff:]
    else:
        gate = linear_apply(lw.w_gate, x)
        up = linear_apply(lw.w_up, x)
    act = torch.nn.functional.silu(gate.to(torch.float32)).to(x.dtype) * up
    return linear_apply(lw.w_down, act)


def forward(cfg: ModelConfig, w: ModelWeights, tokens, positions, k_caches: list,
            v_caches: list, mask_positions, cache_slots, last_idx=None) -> torch.Tensor:
    """One decode/prefill step; returns logits [B, T, V] f32 (or [B, 1, V]
    with ``last_idx``). The index inputs ([B, T] int tokens, positions,
    mask positions (-1 = padded row) and cache slots) may live on the host:
    the K/V store reads its start slots there, and the rest is copied to the
    weights' device. The caches are updated in place."""
    dev = w.device
    tokens = torch.as_tensor(tokens).to(dev)
    positions = torch.as_tensor(positions).to(dev)
    s_l = k_caches[0].shape[2]
    starts = _store_starts(cache_slots, mask_positions, s_l, tokens.shape[1])
    mask_dev = torch.as_tensor(mask_positions).to(dev)
    x = embed_rows(w.embed, tokens)
    for li, lw in enumerate(w.layers):
        h = rms_norm(x, lw.attn_norm, cfg.rms_eps)
        x = x + attention(cfg, lw, h, positions, k_caches[li], v_caches[li],
                          mask_dev, starts)
        h = rms_norm(x, lw.ffn_norm, cfg.rms_eps)
        x = x + ffn(cfg, lw, h)
    if last_idx is not None:
        idx = torch.as_tensor(last_idx).to(dev).clamp_min(0).to(torch.int64)
        x = torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[-1]))
    x = rms_norm(x, w.final_norm, cfg.rms_eps)
    return linear_apply(w.lm_head, x).to(torch.float32)


# ---------------------------------------------------------------------------
# Weight builders
# ---------------------------------------------------------------------------

def random_weights(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                   quantize: bool = False, scale: float = 0.02,
                   device="cpu") -> ModelWeights:
    """Random weights from a NumPy generator (the JAX builder's draw order),
    optionally TCQ4-quantized on the host; tied dense lm_head."""
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
        layers.append(LayerWeights(
            attn_norm=ones(e),
            wq=lin(e, hq), wk=lin(e, hkv), wv=lin(e, hkv), wo=lin(hq, e),
            q_norm=ones(d) if cfg.qk_norm else None,
            k_norm=ones(d) if cfg.qk_norm else None,
            ffn_norm=ones(e),
            w_gate=lin(e, f), w_up=lin(e, f), w_down=lin(f, e),
        ))
    embed = tens(rng.standard_normal((cfg.vocab_size, e)) * scale)
    return ModelWeights(embed=embed, layers=layers, final_norm=ones(e),
                        lm_head=DenseLinear(w=embed.t()))


def fabricated_tcq4_weights(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                            device=None) -> ModelWeights:
    """Structurally valid random TCQ4 weights drawn directly (no quantizer),
    on the device from a seeded ``torch.Generator``: fused qkv and gate-up
    projections with uniform qs bytes and bf16
    eff in [0.001, 0.011), a Q8 lm_head padded by ``n_pad_width`` with f32
    scales in [0, 0.001). For throughput runs, where the compute cost is what
    matters and the weight values are not."""
    from rrs_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def qlin(k, n):
        qs = torch.randint(0, 256, (k // 2, n), generator=gen, device=dev, dtype=torch.uint8)
        eff = (torch.rand((k // 32, n), generator=gen, device=dev) * 0.01 + 0.001
               ).to(torch.bfloat16)
        return TCQ4Linear(qs=qs, eff=eff)

    e, hq, hkv, d, f = cfg.n_embd, cfg.n_q_dim, cfg.n_kv_dim, cfg.head_dim, cfg.n_ff
    ones = lambda n: torch.ones((n,), dtype=dtype, device=dev)   # noqa: E731
    layers = []
    for _ in range(cfg.n_layers):
        norms = dict(attn_norm=ones(e), ffn_norm=ones(e),
                     q_norm=ones(d) if cfg.qk_norm else None,
                     k_norm=ones(d) if cfg.qk_norm else None)
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


def to_device(obj, device):
    """A copy of a weights tree (dataclasses, lists, tuples of tensors) on
    ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device) for f in dataclasses.fields(obj)})
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(o, device) for o in obj)
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
    bias = _tensor(d.get("bias"), device)
    if "qs" in d:
        if d.get("i8p") is not None:
            raise NotImplementedError("the i8p prefill pack is not ported to rrs_tpu_torch")
        gather = d.get("gather")
        return TCQ4Linear(
            qs=_tensor(d["qs"], device), eff=_tensor(d["eff"], device, torch.bfloat16),
            gather=None if gather is None else _tensor(gather, device, torch.int64),
            bias=bias)
    if "q" in d:
        return Q8Linear(q=_tensor(d["q"], device), scale=_tensor(d["scale"], device),
                        bias=bias, n_logical=int(d.get("n_logical", 0) or 0),
                        k_logical=int(d.get("k_logical", 0) or 0))
    if "w" in d:
        return DenseLinear(w=_tensor(d["w"], device), bias=bias)
    raise NotImplementedError(f"linear layer with fields {sorted(d)} is not ported")


_LAYER_LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "wqkv", "w_gateup")
_LAYER_NORMS = ("attn_norm", "q_norm", "k_norm", "ffn_norm")


def weights_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> ModelWeights:
    """Build the port's weights from the JAX package's parameters, given as a
    plain nested dict of NumPy arrays keyed by the JAX dataclass field names:
    ``embed`` (an array, or a (q, scale) pair), ``final_norm``, ``lm_head``
    and ``layers[i]`` with ``attn_norm``, ``wqkv`` ({qs, eff, gather, bias}),
    ``lm_head`` ({q, scale, n_logical, k_logical} or {w, bias}), and so on.
    Fields this dense slice does not carry (MoE, MLA, sinks, sandwich norms)
    must be None."""
    from rrs_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    layers = []
    for ld in tree["layers"]:
        extra = [k for k, v in ld.items()
                 if v is not None and k not in _LAYER_LINEARS + _LAYER_NORMS]
        if extra:
            raise NotImplementedError(f"layer fields {extra} are not ported to rrs_tpu_torch")
        layers.append(LayerWeights(
            **{k: _tensor(ld.get(k), dev) for k in _LAYER_NORMS},
            **{k: _linear_from_numpy(ld.get(k), dev) for k in _LAYER_LINEARS}))
    emb = tree["embed"]
    if isinstance(emb, (tuple, list)):
        embed = (_tensor(emb[0], dev), _tensor(emb[1], dev))
    else:
        embed = _tensor(emb, dev)
    return ModelWeights(embed=embed, layers=layers,
                        final_norm=_tensor(tree["final_norm"], dev),
                        lm_head=_linear_from_numpy(tree["lm_head"], dev))
