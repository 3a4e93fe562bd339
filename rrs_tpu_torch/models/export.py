"""Random-weight GGUF export for the dense llama-family configurations.

Port of the dense branch of ``rrs_tpu/models/export.py``
``export_random_gguf``: the same metadata keys, tensor names and NumPy draw
order, so that the same seed writes the same file. Mixture-of-experts,
gpt-oss, MLA and recurrent configurations wait for ROADMAP A10.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from rrs_tpu_torch.gguf.constants import GGUFValueType
from rrs_tpu_torch.gguf.writer import GGUFWriter
from rrs_tpu_torch.models.config import ModelConfig


def export_random_gguf(cfg: ModelConfig, path: str | Path, seed: int = 0, scale: float = 0.05,
                       dtype=np.float32, vocab_tokens: list[str] | None = None,
                       vocab_model: str = "gpt2") -> Path:
    """Write a GGUF with N(0, scale) weights and unit norms matching the
    dense ``cfg``, every tensor in ``dtype`` (float32 or float16);
    ``vocab_tokens`` adds a tokenizer of ``vocab_model``."""
    if cfg.n_experts or cfg.arch == "gpt-oss" or cfg.swa_window or cfg.is_recurrent \
            or cfg.is_hybrid:
        raise NotImplementedError(f"{cfg.arch} export waits for ROADMAP A10")
    rng = np.random.default_rng(seed)
    w = GGUFWriter(path)
    a = cfg.arch
    u32, f32, s = GGUFValueType.UINT32, GGUFValueType.FLOAT32, GGUFValueType.STRING
    w.add_kv("general.architecture", a, s)
    w.add_kv("general.name", f"random-{a}", s)
    for key, value in (("block_count", cfg.n_layers), ("context_length", cfg.context_length),
                       ("embedding_length", cfg.n_embd), ("feed_forward_length", cfg.n_ff),
                       ("attention.head_count", cfg.n_heads),
                       ("attention.head_count_kv", cfg.n_kv_heads),
                       ("attention.key_length", cfg.head_dim),
                       ("attention.value_length", cfg.head_dim)):
        w.add_kv(f"{a}.{key}", value, u32)
    w.add_kv(f"{a}.attention.layer_norm_rms_epsilon", cfg.rms_eps, f32)
    w.add_kv(f"{a}.rope.freq_base", cfg.rope_theta, f32)
    w.add_kv(f"{a}.vocab_size", cfg.vocab_size, u32)
    if vocab_tokens is not None:
        w.add_kv("tokenizer.ggml.model", vocab_model, s)
        w.add_kv("tokenizer.ggml.tokens", vocab_tokens, GGUFValueType.ARRAY)

    def t(name, shape):
        w.add_tensor(name, (rng.standard_normal(shape) * scale).astype(dtype))

    def norm(name, n):
        w.add_tensor(name, np.ones((n,), dtype))

    e, hq, hkv, d, f = cfg.n_embd, cfg.n_q_dim, cfg.n_kv_dim, cfg.head_dim, cfg.n_ff
    t("token_embd.weight", (cfg.vocab_size, e))
    for i in range(cfg.n_layers):
        p = f"blk.{i}"
        norm(f"{p}.attn_norm.weight", e)
        t(f"{p}.attn_q.weight", (hq, e))
        t(f"{p}.attn_k.weight", (hkv, e))
        t(f"{p}.attn_v.weight", (hkv, e))
        t(f"{p}.attn_output.weight", (e, hq))
        if cfg.attn_bias:
            t(f"{p}.attn_q.bias", (hq,))
            t(f"{p}.attn_k.bias", (hkv,))
            t(f"{p}.attn_v.bias", (hkv,))
        if cfg.qk_norm:
            norm(f"{p}.attn_q_norm.weight", d)
            norm(f"{p}.attn_k_norm.weight", d)
        norm(f"{p}.ffn_norm.weight", e)
        t(f"{p}.ffn_gate.weight", (f, e))
        t(f"{p}.ffn_up.weight", (f, e))
        t(f"{p}.ffn_down.weight", (e, f))
    norm("output_norm.weight", e)
    if not cfg.tie_embeddings:
        t("output.weight", (cfg.vocab_size, e))
    return w.write()
