"""Shared helpers for the tests that hold rrs_tpu_torch against rrs_tpu.

Inputs are made with NumPy from a seed and handed to both packages; the JAX
package's weights cross over as the plain nested dict of NumPy arrays that
``rrs_tpu_torch.models.llama.weights_from_numpy`` takes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# The 2-layer model of tests/test_pipeline_e2e.py (every TCQ4 K a multiple of 256).
SMALL = dict(arch="qwen3", n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2,
             head_dim=64, n_ff=512, vocab_size=256, context_length=512, qk_norm=True)


def jax_cfg(**over):
    from rrs_tpu.models.config import ModelConfig

    return ModelConfig(**{**SMALL, **over})


def torch_cfg(cfg):
    """The port's ModelConfig with the fields of a JAX one."""
    from rrs_tpu_torch.models.config import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: getattr(cfg, k) for k in names})


def to_numpy(x):
    return None if x is None else np.asarray(x)


def linear_tree(layer):
    """A JAX linear dataclass -> dict of NumPy arrays (ints kept as ints)."""
    if layer is None:
        return None
    out = {}
    for f in dataclasses.fields(layer):
        v = getattr(layer, f.name)
        out[f.name] = v if isinstance(v, (int, float)) or v is None else to_numpy(v)
    return out


def weights_tree(w) -> dict:
    """JAX ModelWeights -> the nested NumPy dict of ``weights_from_numpy``."""
    def layer(lw):
        d = {}
        for f in dataclasses.fields(lw):
            v = getattr(lw, f.name)
            if v is None:
                d[f.name] = None
            elif dataclasses.is_dataclass(v):
                d[f.name] = linear_tree(v)
            else:
                d[f.name] = to_numpy(v)
        return d

    embed = w.embed
    embed = tuple(to_numpy(e) for e in embed) if isinstance(embed, tuple) else to_numpy(embed)
    return {"embed": embed, "layers": [layer(lw) for lw in w.layers],
            "final_norm": to_numpy(w.final_norm), "lm_head": linear_tree(w.lm_head)}


def small_jax_model(seed: int = 0, perm_layer: bool = False):
    """2-layer JAX model: random TCQ4 weights fused into qkv / gate-up and a
    Q8_0 lm_head, as the real loader builds them. ``perm_layer``: the last
    layer's qkv is quantized under a block-local channel permutation, so its
    activations take the gathered rotation."""
    from rrs_tpu.formats.tcq4 import quantize_tcq4
    from rrs_tpu.models import llama as jllama
    from rrs_tpu.models.linear import Q8Linear, TCQ4Linear, fuse_linears

    cfg = jax_cfg()
    w = jllama.random_weights(cfg, seed=seed, quantize=True)
    rng = np.random.default_rng(seed + 100)
    for lw in w.layers:
        lw.wqkv = fuse_linears([lw.wq, lw.wk, lw.wv])
        lw.w_gateup = fuse_linears([lw.w_gate, lw.w_up])
        lw.wq = lw.wk = lw.wv = lw.w_gate = lw.w_up = None
    if perm_layer:
        e, n = cfg.n_embd, cfg.n_q_dim + 2 * cfg.n_kv_dim
        perm = np.concatenate([rng.permutation(256) + 256 * b for b in range(e // 256)])
        wqkv = (rng.standard_normal((n, e)) * 0.02).astype(np.float32)
        w.layers[-1].wqkv = TCQ4Linear.from_tensor(quantize_tcq4(wqkv, perm=perm))
    head = (rng.standard_normal((cfg.vocab_size, cfg.n_embd)) * 0.05).astype(np.float32)
    w.lm_head = Q8Linear.quantize(head)
    return cfg, w


def rel_err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))
