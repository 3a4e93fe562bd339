"""Model hyperparameters from GGUF metadata: the Qwen3 / Qwen2 / Llama,
Qwen2-MoE, Qwen3-MoE and gpt-oss subset of ``rrs_tpu/models/config.py``.

gpt-oss brings the MoE fields (MXFP4 experts, swiglu_oai, top-k on raw logits
then a softmax over the k), alternating sliding-window layers over ring
caches, per-head sinks and qkv / output biases. qwen3moe is qwen3 (q/k norms,
no attention bias) with every layer MoE: softmax gating, and the post-top-k
norm when the GGUF sets ``qwen3moe.norm_topk_prob``. qwen2moe is qwen2 (qkv
bias, no q/k norms) with every layer MoE plus a dense SwiGLU shared expert,
added with no gate as in the JAX package (the published model gates it; ROADMAP
queue C). Llama / Qwen GGUFs with ``attention.sliding_window`` take every
layer sliding (pattern 1), as in the JAX package. Other architectures, MoE
layers in a dense architecture and RoPE scaling other than ``none`` /
``llama3`` / ``yarn`` raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

SUPPORTED_ARCHS = ("llama", "qwen2", "qwen3", "qwen2moe", "qwen3moe", "gpt-oss")
MOE_ARCHS = ("qwen2moe", "qwen3moe", "gpt-oss")


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
    # MoE (0 => dense)
    n_experts: int = 0
    n_experts_used: int = 0
    n_ff_exp: int = 0
    expert_gating_softmax: bool = True
    norm_topk_prob: bool = False
    expert_weights_scale: float = 1.0
    expert_weights_norm: bool = False
    n_expert_groups: int = 0
    n_group_used: int = 0
    # gpt-oss: top-k on the raw router logits, softmax over the selected k,
    # and the clamped swiglu_oai expert activation
    expert_softmax_weight: bool = False
    moe_act: str = "silu"            # "silu" | "swiglu_oai"
    # sliding-window attention: 0 => none; pattern 1 => every layer; n > 1
    # => layer li is sliding iff li % n < n - 1 (gpt-oss: 2, even layers)
    swa_window: int = 0
    swa_pattern: int = 0
    rope_theta_swa: float = 0.0      # 0 => sliding layers share rope_theta

    @property
    def n_q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def n_kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def is_swa(self, li: int) -> bool:
        """Is layer ``li`` sliding-window (over a ring cache)?"""
        if self.swa_window <= 0 or self.swa_pattern <= 0:
            return False
        if self.swa_pattern == 1:
            return True
        return li % self.swa_pattern < self.swa_pattern - 1

    @property
    def any_swa(self) -> bool:
        return self.swa_window > 0 and self.swa_pattern > 0

    @staticmethod
    def from_gguf(md: Mapping[str, Any]) -> "ModelConfig":
        arch = md["general.architecture"]
        if arch not in SUPPORTED_ARCHS:
            raise NotImplementedError(
                f"architecture {arch!r} is not ported to rrs_tpu_torch "
                f"(supported: {', '.join(SUPPORTED_ARCHS)})")

        def key(suffix, default=None):
            return md.get(f"{arch}.{suffix}", default)

        if arch not in MOE_ARCHS and int(key("expert_count", 0) or 0) > 0:
            raise NotImplementedError(
                f"{arch} MoE layers: only the MoE architectures {', '.join(MOE_ARCHS)} are "
                "ported")
        scaling = str(key("rope.scaling.type", "none") or "none")
        if scaling not in ("none", "llama3", "yarn"):
            raise NotImplementedError(f"rope scaling {scaling!r} is not ported to rrs_tpu_torch")
        extra: dict = {}
        if arch == "gpt-oss":
            # alternating sliding layers (pattern 2, even layers), sinks,
            # biases, swiglu_oai experts and the post-top-k softmax
            extra.update(
                swa_window=int(key("attention.sliding_window", 128) or 128),
                swa_pattern=2,
                rope_theta_swa=float(key("rope.freq_base_swa", 0.0) or 0.0),
                expert_softmax_weight=True,
                moe_act="swiglu_oai",
            )
        else:
            # llama / qwen: every layer sliding when the key is present
            win = int(key("attention.sliding_window", 0) or 0)
            if win > 0:
                extra.update(swa_window=win, swa_pattern=1)
        n_embd = int(key("embedding_length"))
        n_heads = int(key("attention.head_count", 0) or 0)
        n_kv = int(key("attention.head_count_kv", n_heads) or 0)
        head_dim = int(key("attention.key_length",
                           n_embd // n_heads if n_heads else 0) or 0)
        vocab = md.get("tokenizer.ggml.tokens")
        vocab_size = int(key("vocab_size", len(vocab) if vocab is not None else 0))
        return ModelConfig(
            **extra,
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
            qk_norm=arch in ("qwen3", "qwen3moe"),
            attn_bias=arch in ("qwen2", "qwen2moe", "gpt-oss"),
            tie_embeddings=bool(md.get(f"{arch}.tie_word_embeddings", False)),
            n_experts=int(key("expert_count", 0) or 0),
            n_experts_used=int(key("expert_used_count", 0) or 0),
            n_ff_exp=int(key("expert_feed_forward_length", 0) or 0),
            norm_topk_prob=bool(key("norm_topk_prob", False)),
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
    # gpt-oss-20b (LLM_TYPE_20B): all-MoE with alternating SWA + sinks,
    # swiglu_oai experts, post-top-k softmax
    "gpt-oss-20b": ModelConfig(
        arch="gpt-oss", n_layers=24, n_embd=2880, n_heads=64, n_kv_heads=8,
        head_dim=64, n_ff=2880, vocab_size=201088, context_length=131072,
        rope_theta=150000.0, rope_scaling_type="yarn",
        rope_scale_factor=32.0, rope_orig_context=4096,
        n_experts=32, n_experts_used=4, n_ff_exp=2880,
        swa_window=128, swa_pattern=2, attn_bias=True,
        expert_softmax_weight=True, moe_act="swiglu_oai",
    ),
    "tiny-oss": ModelConfig(
        arch="gpt-oss", n_layers=3, n_embd=128, n_heads=4, n_kv_heads=2,
        head_dim=32, n_ff=256, vocab_size=512, context_length=1024,
        n_experts=4, n_experts_used=2, n_ff_exp=64,
        swa_window=8, swa_pattern=2, attn_bias=True,
        expert_softmax_weight=True, moe_act="swiglu_oai",
    ),
    "tiny": ModelConfig(
        arch="qwen3", n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2,
        head_dim=64, n_ff=512, vocab_size=512, context_length=1024,
        qk_norm=True, tie_embeddings=True,
    ),
}
