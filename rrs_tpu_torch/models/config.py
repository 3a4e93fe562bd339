"""Model hyperparameters from GGUF metadata: the dense Qwen3 / Qwen2 / Llama
subset of ``rrs_tpu/models/config.py``.

Any other architecture, sliding-window attention and RoPE scaling other than
``none`` / ``llama3`` raise NotImplementedError until their slice is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

SUPPORTED_ARCHS = ("llama", "qwen2", "qwen3")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    n_layers: int
    n_embd: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    n_ff: int
    vocab_size: int
    context_length: int
    rms_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling_type: str = "none"
    rope_scale_factor: float = 1.0
    rope_orig_context: int = 0
    rope_neox: bool = True
    qk_norm: bool = False            # qwen3-style per-head q/k RMSNorm
    attn_bias: bool = False          # qwen2-style qkv bias
    tie_embeddings: bool = False

    @property
    def n_q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def n_kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @staticmethod
    def from_gguf(md: Mapping[str, Any]) -> "ModelConfig":
        arch = md["general.architecture"]
        if arch not in SUPPORTED_ARCHS:
            raise NotImplementedError(
                f"architecture {arch!r} is not ported to rrs_tpu_torch "
                f"(supported: {', '.join(SUPPORTED_ARCHS)})")

        def key(suffix, default=None):
            return md.get(f"{arch}.{suffix}", default)

        if int(key("attention.sliding_window", 0) or 0) > 0:
            raise NotImplementedError("sliding-window attention is not ported to rrs_tpu_torch")
        if int(key("expert_count", 0) or 0) > 0:
            raise NotImplementedError("MoE layers are not ported to rrs_tpu_torch")
        scaling = str(key("rope.scaling.type", "none") or "none")
        if scaling not in ("none", "llama3"):
            raise NotImplementedError(f"rope scaling {scaling!r} is not ported to rrs_tpu_torch")
        n_embd = int(key("embedding_length"))
        n_heads = int(key("attention.head_count", 0) or 0)
        n_kv = int(key("attention.head_count_kv", n_heads) or 0)
        head_dim = int(key("attention.key_length",
                           n_embd // n_heads if n_heads else 0) or 0)
        vocab = md.get("tokenizer.ggml.tokens")
        vocab_size = int(key("vocab_size", len(vocab) if vocab is not None else 0))
        return ModelConfig(
            arch=arch,
            n_layers=int(key("block_count")),
            n_embd=n_embd,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            n_ff=int(key("feed_forward_length", 0) or 0),
            vocab_size=vocab_size,
            context_length=int(key("context_length", 4096)),
            rms_eps=float(key("attention.layer_norm_rms_epsilon", 1e-6)),
            rope_theta=float(key("rope.freq_base", 10000.0)),
            rope_scaling_type=scaling,
            rope_scale_factor=float(key("rope.scaling.factor", 1.0) or 1.0),
            rope_orig_context=int(key("rope.scaling.original_context_length", 0) or 0),
            # llama weights are pre-permuted for interleaved (NORM) rope
            rope_neox=arch != "llama",
            qk_norm=arch == "qwen3",
            attn_bias=arch == "qwen2",
            tie_embeddings=bool(md.get(f"{arch}.tie_word_embeddings", False)),
        )


PRESETS: dict[str, ModelConfig] = {
    "qwen3-0.6b": ModelConfig(
        arch="qwen3", n_layers=28, n_embd=1024, n_heads=16, n_kv_heads=8,
        head_dim=128, n_ff=3072, vocab_size=151936, context_length=40960,
        rope_theta=1e6, qk_norm=True, tie_embeddings=True,
    ),
    "qwen3-4b": ModelConfig(
        arch="qwen3", n_layers=36, n_embd=2560, n_heads=32, n_kv_heads=8,
        head_dim=128, n_ff=9728, vocab_size=151936, context_length=40960,
        rope_theta=1e6, qk_norm=True, tie_embeddings=True,
    ),
    "llama-3-8b": ModelConfig(
        arch="llama", n_layers=32, n_embd=4096, n_heads=32, n_kv_heads=8,
        head_dim=128, n_ff=14336, vocab_size=128256, context_length=8192,
        rope_theta=500000.0, rope_neox=False,
    ),
    "tiny": ModelConfig(
        arch="qwen3", n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2,
        head_dim=64, n_ff=512, vocab_size=512, context_length=1024,
        qk_norm=True, tie_embeddings=True,
    ),
}
