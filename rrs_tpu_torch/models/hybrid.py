"""Hybrid (Jamba) architecture: each layer is norm -> {Mamba block |
attention without RoPE} -> residual -> norm -> {dense SwiGLU FFN | MoE} ->
residual.

Port of ``rrs_tpu/models/hybrid.py``. Attention layers take
``llama.attention`` (B3 over a bf16 cache, ``cfg.no_rope``), which writes
their K/V rows into the cache in place; Mamba layers take
``mamba.mamba_block`` over their conv / ssm states, which the forward
returns; the FFN is ``llama.ffn`` (dense, or ``moe_ffn`` over TCQ4 or dense
expert stacks). Per-layer cache lists hold None for the other kind.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from rrs_tpu_torch.models import llama
from rrs_tpu_torch.models import mamba
from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.models.linear import DenseLinear, linear_apply
from rrs_tpu_torch.ops.basic import rms_norm


@dataclasses.dataclass
class HybridLayer:
    kind: str                      # "attn" | "ssm"
    attn: Any                      # llama.LayerWeights (its FFN fields unused)
    ssm: Any                       # mamba.MambaLayer
    ffn_norm: torch.Tensor
    w_gate: Any
    w_up: Any
    w_down: Any
    moe: Any = None
    w_gateup: Any = None           # unused: the JAX package keeps gate and up apart


@dataclasses.dataclass
class HybridWeights:
    embed: torch.Tensor
    layers: list
    final_norm: torch.Tensor
    lm_head: Any

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


def forward(cfg: ModelConfig, w: HybridWeights, tokens: torch.Tensor, positions: torch.Tensor,
            k_caches: list, v_caches: list, conv_states: list, ssm_states: list,
            mask_positions: torch.Tensor, slots: list):
    """tokens, positions, mask_positions [B, T] on the weights' device (mask
    -1 = padded lane); ``slots``: each lane's first cache slot (-1 = padded),
    as ``llama.attention`` takes them. The attention layers' K/V are written
    in place; returns (logits [B, T, V] f32, new conv states, new ssm
    states), a padded lane keeping its own."""
    x = w.embed[tokens.clamp_min(0)]
    active = mask_positions[:, 0] >= 0
    nc, ns = list(conv_states), list(ssm_states)
    for li, hl in enumerate(w.layers):
        if hl.kind == "attn":
            h = rms_norm(x, hl.attn.attn_norm, cfg.rms_eps)
            out = llama.attention(cfg, hl.attn, h, positions, k_caches[li], v_caches[li],
                                  mask_positions, slots, li=li)
        else:
            h = rms_norm(x, hl.ssm.norm, cfg.rms_eps)
            out, c_new, s_new = mamba.mamba_block(cfg, hl.ssm, h, conv_states[li],
                                                  ssm_states[li])
            nc[li] = mamba.keep_inactive(c_new, conv_states[li], active)
            ns[li] = mamba.keep_inactive(s_new, ssm_states[li], active)
        x = x + out
        x = x + llama.ffn(cfg, hl, rms_norm(x, hl.ffn_norm, cfg.rms_eps))
    x = rms_norm(x, w.final_norm, cfg.rms_eps)
    return linear_apply(w.lm_head, x).to(torch.float32), nc, ns


def _attn_layer(norm, wq, wk, wv, wo) -> llama.LayerWeights:
    return llama.LayerWeights(attn_norm=norm, wq=wq, wk=wk, wv=wv, wo=wo, q_norm=None,
                              k_norm=None, ffn_norm=None, w_gate=None, w_up=None, w_down=None)


def random_weights(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16, attn_every: int = 4,
                   device="cpu") -> HybridWeights:
    """Random dense weights in the draw order of the JAX ``random_weights``:
    layer li is attention iff li % attn_every == attn_every - 1, its Mamba
    layers carry unit dt / B / C norms; dense SwiGLU FFNs; tied head."""
    rng = np.random.default_rng(seed)

    def tens(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device=device, dtype=dt)

    def lin(k, n, scale=0.02):
        return DenseLinear(w=tens(rng.standard_normal((k, n)) * scale))

    ones = lambda n: torch.ones((n,), dtype=dtype, device=device)   # noqa: E731
    e, f = cfg.n_embd, cfg.n_ff
    layers = []
    for li in range(cfg.n_layers):
        attn = ssm = None
        if li % attn_every == attn_every - 1:
            attn = _attn_layer(ones(e), lin(e, cfg.n_q_dim), lin(e, cfg.n_kv_dim),
                               lin(e, cfg.n_kv_dim), lin(cfg.n_q_dim, e))
        else:
            ssm = mamba.random_layer(cfg, rng, lin, tens, ones, norms=True)
        layers.append(HybridLayer(kind="attn" if attn is not None else "ssm", attn=attn, ssm=ssm,
                                  ffn_norm=ones(e), w_gate=lin(e, f), w_up=lin(e, f),
                                  w_down=lin(f, e)))
    embed = tens(rng.standard_normal((cfg.vocab_size, e)) * 0.02)
    return HybridWeights(embed=embed, layers=layers, final_norm=ones(e),
                         lm_head=DenseLinear(w=embed.t()))


def fabricated_tcq4_weights(cfg: ModelConfig, seed: int = 0, device=None,
                            quantized: bool = True, attn_period: int = 8,
                            attn_offset: int = 4, expert_period: int = 2,
                            expert_offset: int = 1) -> HybridWeights:
    """Jamba weights drawn on the device (``mamba.Fabricator``) in Jamba's
    layout: attention at layer ``attn_offset`` of every ``attn_period``
    (unfused q / k / v / o, as the loaders keep them), Mamba layers with
    unit dt / B / C norms elsewhere; an MoE FFN (a router N(0, 0.05) in bf16,
    TCQ4 expert stacks of uniform qs bytes and bf16 eff in [0.001, 0.011))
    at layer ``expert_offset`` of every ``expert_period``, a dense SwiGLU FFN
    elsewhere; every projection TCQ4 with its i8p pack; a bf16 embedding
    N(0, 0.02) and an untied Q8_0 head. ``quantized=False`` draws bf16
    linears, dense expert stacks N(0, 0.05) and head (the card-vs-CPU glue
    checks)."""
    from rrs_tpu_torch.models.moe import MoEWeights

    fab = mamba.Fabricator(seed, device, quantized)
    e, f = cfg.n_embd, cfg.n_ff
    norm = lambda: (1.0 + fab.normal(0.2, (e,), torch.float32)).to(torch.bfloat16)  # noqa: E731

    def experts():
        n_exp, fe = cfg.n_experts, cfg.n_ff_exp or f
        router = fab.normal(0.05, (e, n_exp))
        if not quantized:
            return MoEWeights(router=router, gate=fab.normal(0.05, (n_exp, e, fe)),
                              up=fab.normal(0.05, (n_exp, e, fe)),
                              down=fab.normal(0.05, (n_exp, fe, e)))
        stacks = {}
        for name, (k, n) in (("gate", (e, fe)), ("up", (e, fe)), ("down", (fe, e))):
            stacks[f"{name}_qs"] = torch.randint(0, 256, (n_exp, k // 2, n), generator=fab.gen,
                                                 device=fab.dev, dtype=torch.uint8)
            stacks[f"{name}_eff"] = fab.uniform(0.001, 0.011, (n_exp, k // 32, n)).to(
                torch.bfloat16)
        return MoEWeights(router=router, quant_kind="tcq4", **stacks)

    layers = []
    for li in range(cfg.n_layers):
        attn = ssm = None
        if li % attn_period == attn_offset:
            attn = _attn_layer(norm(), fab.lin(e, cfg.n_q_dim), fab.lin(e, cfg.n_kv_dim),
                               fab.lin(e, cfg.n_kv_dim), fab.lin(cfg.n_q_dim, e))
        else:
            ssm = fab.mamba_layer(cfg, norms=True)
        moe = experts() if cfg.n_experts and li % expert_period == expert_offset else None
        layers.append(HybridLayer(
            kind="attn" if attn is not None else "ssm", attn=attn, ssm=ssm, ffn_norm=norm(),
            w_gate=None if moe else fab.lin(e, f), w_up=None if moe else fab.lin(e, f),
            w_down=None if moe else fab.lin(f, e), moe=moe))
    return HybridWeights(embed=fab.normal(0.02, (cfg.vocab_size, e)), layers=layers,
                         final_norm=fab.ones(e), lm_head=fab.head(e, cfg.vocab_size))


def weights_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> HybridWeights:
    """The port's weights from the JAX HybridWeights given as a nested dict
    of NumPy arrays keyed by its field names: ``layers[i]`` holds ``kind``,
    ``attn`` (the LayerWeights fields) or ``ssm`` (the MambaLayer fields),
    ``ffn_norm``, the FFN linears and ``moe``."""
    from rrs_tpu_torch.device import resolve_device
    from rrs_tpu_torch.models.llama import _linear_from_numpy, _moe_from_numpy, _tensor

    dev = resolve_device(device)
    layers = []
    for ld in tree["layers"]:
        attn = None
        if ld.get("attn") is not None:
            a = ld["attn"]
            attn = _attn_layer(_tensor(a["attn_norm"], dev),
                               *(_linear_from_numpy(a[k], dev) for k in ("wq", "wk", "wv", "wo")))
        layers.append(HybridLayer(
            kind=str(ld["kind"]), attn=attn,
            ssm=None if ld.get("ssm") is None else mamba.layer_from_numpy(ld["ssm"], dev),
            ffn_norm=_tensor(ld["ffn_norm"], dev),
            **{k: _linear_from_numpy(ld.get(k), dev) for k in ("w_gate", "w_up", "w_down")},
            moe=_moe_from_numpy(ld.get("moe"), dev)))
    return HybridWeights(embed=_tensor(tree["embed"], dev), layers=layers,
                         final_norm=_tensor(tree["final_norm"], dev),
                         lm_head=_linear_from_numpy(tree["lm_head"], dev))
