"""RWKV6 architecture (rwkv6 and rwkv6qwen2 files).

Port of ``rrs_tpu/models/rwkv6.py``. Per layer (two token shifts):

  att_norm = LN(x); x_prev = [shift_attn, att_norm[:-1]]
  time mix: the 5-way low-rank lerp (w1 / w2) -> xw / xk / xv / xr / xg; the
  r / k / v / g projections; the per-token decay td = exp(-exp(decay_lora(xw)
  + decay)); ``wkv6`` with the bonus tf; the per-head group norm (eps 64e-5)
  and the time_mix_ln affine; times silu(g); the output projection; residual.
  ffn_norm = LN(x); channel mix: r = sigmoid(R(xr)), k = relu(K(xk))^2,
  out = r * V(k); residual. x is halved every ``rwkv_rescale_every`` layers.

The five r / k / v / g / output projections and the channel mix's three go
through ``linear_apply`` (the TCQ4 / Q8 kernels, or a dense matmul); the
lerps, the decay LoRA and ``wkv6`` are plain f32 torch, as they are plain jnp
in the JAX package.

Recurrent state per layer per lane: the token shifts [2, E] (the last
att_norm and ffn_norm rows, in the cache dtype) and the wkv state [H, D, D]
f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.models.linear import DenseLinear, linear_apply
from rrs_tpu_torch.models.mamba import Fabricator, keep_inactive
from rrs_tpu_torch.ops.basic import layer_norm
from rrs_tpu_torch.ops.rwkv import wkv6


@dataclasses.dataclass
class Rwkv6Layer:
    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    tm_w1: torch.Tensor            # [E, 5 * extra]
    tm_w2: torch.Tensor            # [5, extra, E]
    tm_lerp_x: torch.Tensor        # [E]
    tm_lerp_fused: torch.Tensor    # [5, E]
    tm_first: torch.Tensor         # [H, D] (the bonus "u")
    tm_decay: torch.Tensor         # [E]
    tm_decay_w1: torch.Tensor      # [E, decay_extra]
    tm_decay_w2: torch.Tensor      # [decay_extra, E]
    w_key: Any
    w_value: Any
    w_recept: Any
    w_gate: Any
    w_out: Any
    tm_ln_w: torch.Tensor          # [E]
    tm_ln_b: torch.Tensor
    cm_lerp_k: torch.Tensor        # [E]
    cm_lerp_r: torch.Tensor
    cm_key: Any
    cm_value: Any
    cm_recept: Any


@dataclasses.dataclass
class Rwkv6Weights:
    embed: torch.Tensor
    tok_norm_w: torch.Tensor
    tok_norm_b: torch.Tensor
    layers: list
    final_norm_w: torch.Tensor
    final_norm_b: torch.Tensor
    lm_head: Any

    @property
    def device(self) -> torch.device:
        return self.final_norm_w.device


def _shifted(x_norm: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """x_prev: [shift, x_norm[:, :-1]] along T (the token-shift concat)."""
    return torch.cat([shift[:, None, :], x_norm[:, :-1]], dim=1)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def time_mix(cfg: ModelConfig, lw: Rwkv6Layer, x_norm: torch.Tensor, x_prev: torch.Tensor,
             wkv_state: torch.Tensor):
    """Returns (the attention branch [B, T, E] in x_norm's dtype, the new wkv
    state)."""
    b, t, e = x_norm.shape
    d = cfg.rwkv_head_size
    h = e // d
    sx = _f32(x_prev - x_norm)
    cur = _f32(x_norm)
    xxx = cur + sx * _f32(lw.tm_lerp_x)
    extra = lw.tm_w1.shape[1] // 5
    low = torch.tanh(xxx @ _f32(lw.tm_w1)).reshape(b, t, 5, extra)
    deltas = torch.einsum("btfe,fex->btfx", low, _f32(lw.tm_w2))          # [B, T, 5, E]
    mixed = cur[:, :, None, :] + sx[:, :, None, :] * (deltas + _f32(lw.tm_lerp_fused))
    xw, xk, xv, xr, xg = (mixed[:, :, i, :] for i in range(5))
    r = linear_apply(lw.w_recept, xr).reshape(b, t, h, d)
    k = linear_apply(lw.w_key, xk).reshape(b, t, h, d)
    v = linear_apply(lw.w_value, xv).reshape(b, t, h, d)
    g = torch.nn.functional.silu(_f32(linear_apply(lw.w_gate, xg)))
    w = torch.tanh(xw @ _f32(lw.tm_decay_w1)) @ _f32(lw.tm_decay_w2) + _f32(lw.tm_decay)
    td = torch.exp(-torch.exp(w)).reshape(b, t, h, d)
    out, new_state = wkv6(k, v, r, lw.tm_first, td, wkv_state)
    # the per-head group norm (ggml_norm over the head size), then the affine
    out = layer_norm(out, eps=64e-5).reshape(b, t, e)
    out = (out * _f32(lw.tm_ln_w) + _f32(lw.tm_ln_b)) * g
    return linear_apply(lw.w_out, out.to(x_norm.dtype)), new_state


def channel_mix(lw: Rwkv6Layer, x_norm: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    sx = _f32(x_prev - x_norm)
    cur = _f32(x_norm)
    xk = (cur + sx * _f32(lw.cm_lerp_k)).to(x_norm.dtype)
    xr = (cur + sx * _f32(lw.cm_lerp_r)).to(x_norm.dtype)
    r = torch.sigmoid(_f32(linear_apply(lw.cm_recept, xr)))
    kk = torch.relu(_f32(linear_apply(lw.cm_key, xk))) ** 2
    return (r * _f32(linear_apply(lw.cm_value, kk.to(x_norm.dtype)))).to(x_norm.dtype)


def forward(cfg: ModelConfig, w: Rwkv6Weights, tokens: torch.Tensor, shift_states: list,
            wkv_states: list, active: Optional[torch.Tensor] = None):
    """tokens [B, T] -> (logits [B, T, V] f32, new shift states [B, 2, E],
    new wkv states [B, H, D, D]); an inactive lane keeps its states."""
    x = w.embed[tokens.clamp_min(0)]
    x = layer_norm(x, w.tok_norm_w, w.tok_norm_b)
    new_shift, new_wkv = [], []
    for li, lw in enumerate(w.layers):
        att_norm = layer_norm(x, lw.ln1_w, lw.ln1_b)
        att_out, wkv_new = time_mix(cfg, lw, att_norm,
                                    _shifted(att_norm, shift_states[li][:, 0]), wkv_states[li])
        x = x + att_out
        ffn_norm = layer_norm(x, lw.ln2_w, lw.ln2_b)
        x = x + channel_mix(lw, ffn_norm, _shifted(ffn_norm, shift_states[li][:, 1]))
        shift_new = torch.stack([att_norm[:, -1], ffn_norm[:, -1]], dim=1)
        new_shift.append(keep_inactive(shift_new, shift_states[li], active)
                         .to(shift_states[li].dtype))
        new_wkv.append(keep_inactive(wkv_new, wkv_states[li], active))
        if cfg.rwkv_rescale_every and (li + 1) % cfg.rwkv_rescale_every == 0:
            x = x * 0.5
    x = layer_norm(x, w.final_norm_w, w.final_norm_b)
    return linear_apply(w.lm_head, x).to(torch.float32), new_shift, new_wkv


# ---------------------------------------------------------------------------
# Weight builders
# ---------------------------------------------------------------------------

def random_weights(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                   device="cpu") -> Rwkv6Weights:
    """Random dense weights in the draw order of the JAX ``random_weights``;
    tied head."""
    rng = np.random.default_rng(seed)
    e, d = cfg.n_embd, cfg.rwkv_head_size
    h = e // d
    extra, dec_extra = cfg.rwkv_tm_extra, cfg.rwkv_decay_extra

    def tens(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device=device, dtype=dt)

    def lin(k, n, s=0.05):
        return DenseLinear(w=tens(rng.standard_normal((k, n)) * s))

    def vec(*shape, s=0.1):
        return tens(rng.standard_normal(shape) * s, torch.float32)

    ones = lambda: torch.ones((e,), device=device)    # noqa: E731
    zeros = lambda: torch.zeros((e,), device=device)  # noqa: E731
    layers = []
    for _ in range(cfg.n_layers):
        layers.append(Rwkv6Layer(
            ln1_w=ones(), ln1_b=zeros(), ln2_w=ones(), ln2_b=zeros(),
            tm_w1=vec(e, 5 * extra, s=0.02), tm_w2=vec(5, extra, e, s=0.02),
            tm_lerp_x=vec(e), tm_lerp_fused=vec(5, e), tm_first=vec(h, d), tm_decay=vec(e),
            tm_decay_w1=vec(e, dec_extra, s=0.02), tm_decay_w2=vec(dec_extra, e, s=0.02),
            w_key=lin(e, e), w_value=lin(e, e), w_recept=lin(e, e), w_gate=lin(e, e),
            w_out=lin(e, e), tm_ln_w=ones(), tm_ln_b=zeros(),
            cm_lerp_k=vec(e), cm_lerp_r=vec(e),
            cm_key=lin(e, cfg.n_ff or e), cm_value=lin(cfg.n_ff or e, e), cm_recept=lin(e, e)))
    embed = tens(rng.standard_normal((cfg.vocab_size, e)) * 0.02)
    return Rwkv6Weights(embed=embed, tok_norm_w=ones(), tok_norm_b=zeros(), layers=layers,
                        final_norm_w=ones(), final_norm_b=zeros(),
                        lm_head=DenseLinear(w=embed.t()))


def fabricated_tcq4_weights(cfg: ModelConfig, seed: int = 0, device=None,
                            quantized: bool = True) -> Rwkv6Weights:
    """RWKV6 weights drawn on the device (``mamba.Fabricator``): the eight
    projections TCQ4 with their i8p packs (RWKV-6 7B: E = 4,096, FF 14,336),
    the lerps N(0, 0.1), the LoRA factors N(0, 0.02), the decay N(-1, 0.5)
    and bonus N(0, 0.1) in f32, the layer norms N(1, 0.1) with zero biases, a
    bf16 embedding N(0, 0.02) and an untied Q8_0 head; ``quantized=False``
    draws bf16 linears and head (the card-vs-CPU glue checks)."""
    fab = Fabricator(seed, device, quantized)
    e, d, f = cfg.n_embd, cfg.rwkv_head_size, cfg.n_ff or cfg.n_embd
    f32 = torch.float32

    def ln():
        return 1.0 + fab.normal(0.1, (e,), f32), torch.zeros((e,), device=fab.dev)

    layers = []
    for _ in range(cfg.n_layers):
        (l1w, l1b), (l2w, l2b), (tmw, tmb) = ln(), ln(), ln()
        layers.append(Rwkv6Layer(
            ln1_w=l1w, ln1_b=l1b, ln2_w=l2w, ln2_b=l2b,
            tm_w1=fab.normal(0.02, (e, 5 * cfg.rwkv_tm_extra), f32),
            tm_w2=fab.normal(0.02, (5, cfg.rwkv_tm_extra, e), f32),
            tm_lerp_x=fab.normal(0.1, (e,), f32), tm_lerp_fused=fab.normal(0.1, (5, e), f32),
            tm_first=fab.normal(0.1, (e // d, d), f32),
            tm_decay=fab.normal(0.5, (e,), f32) - 1.0,
            tm_decay_w1=fab.normal(0.02, (e, cfg.rwkv_decay_extra), f32),
            tm_decay_w2=fab.normal(0.02, (cfg.rwkv_decay_extra, e), f32),
            w_key=fab.lin(e, e), w_value=fab.lin(e, e), w_recept=fab.lin(e, e),
            w_gate=fab.lin(e, e), w_out=fab.lin(e, e), tm_ln_w=tmw, tm_ln_b=tmb,
            cm_lerp_k=fab.normal(0.1, (e,), f32), cm_lerp_r=fab.normal(0.1, (e,), f32),
            cm_key=fab.lin(e, f), cm_value=fab.lin(f, e), cm_recept=fab.lin(e, e)))
    ones, zeros = fab.ones(e, f32), torch.zeros((e,), device=fab.dev)
    return Rwkv6Weights(embed=fab.normal(0.02, (cfg.vocab_size, e)), tok_norm_w=ones,
                        tok_norm_b=zeros, layers=layers, final_norm_w=ones, final_norm_b=zeros,
                        lm_head=fab.head(e, cfg.vocab_size))


_LAYER_LINEARS = ("w_key", "w_value", "w_recept", "w_gate", "w_out", "cm_key", "cm_value",
                  "cm_recept")


def weights_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> Rwkv6Weights:
    """The port's weights from the JAX Rwkv6Weights given as a nested dict
    of NumPy arrays keyed by its field names (each linear a dict as
    ``llama.weights_from_numpy`` takes it)."""
    from rrs_tpu_torch.device import resolve_device
    from rrs_tpu_torch.models.llama import _linear_from_numpy, _tensor

    dev = resolve_device(device)
    layers = [Rwkv6Layer(**{k: (_linear_from_numpy(v, dev) if k in _LAYER_LINEARS
                                else _tensor(v, dev)) for k, v in ld.items()})
              for ld in tree["layers"]]
    top = {k: _tensor(tree[k], dev) for k in ("embed", "tok_norm_w", "tok_norm_b",
                                              "final_norm_w", "final_norm_b")}
    return Rwkv6Weights(layers=layers, lm_head=_linear_from_numpy(tree["lm_head"], dev), **top)
