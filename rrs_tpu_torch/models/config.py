"""Model hyperparameters from GGUF metadata: the attention families of
``rrs_tpu/models/config.py``.

Ported: llama / mistral / qwen2 / qwen3 (dense, or with MoE layers when the
GGUF has ``expert_count``), qwen2moe / qwen3moe, gpt-oss, deepseek2 (MLA,
with its leading dense layers and V2's softmax or V3's sigmoid / group /
selection-bias routing), gemma2 / gemma3 (softcaps, GELU, the sqrt(E)
embedding scale, sandwich norms, sliding patterns 2 and 6), granite /
minicpm (embedding, residual and logit scales), olmo2 (post-norm-only
layers, q / k normed over the whole projection) and phi3 (partial rotary,
LongRoPE factors, pre-fused qkv). gpt-oss brings the MXFP4 experts, swiglu_oai,
top-k on raw logits then a softmax over the k, alternating sliding-window
layers over ring caches, per-head sinks and qkv / output biases. qwen2moe adds
a dense SwiGLU shared expert, added with no gate as in the JAX package (the
published model gates it; ROADMAP queue C). Llama / Qwen / Mistral / phi3
GGUFs with ``attention.sliding_window`` take every layer sliding (pattern 1),
as in the JAX package.

The recurrent families read as the JAX package reads them: mamba, mamba2
and falcon_mamba (the ``ssm.*`` keys, with falcon-mamba's ``ssm.dt_b_c_rms``),
rwkv6 and rwkv6qwen2 (head size, the low-rank extra widths and
``rescale_every_n_layers``), and the hybrid jamba (the ``ssm.*`` keys, and
attention without RoPE). ``is_recurrent`` / ``is_hybrid`` pick their memories
(``runtime/recurrent.py``'s ``make_context``). qwen2vl, the text stack of
Qwen2-VL / Qwen2.5-VL, is qwen2's body (qkv biases) with M-RoPE: its
``rope.dimension_sections`` become ``rope_sections``. Any other architecture,
and RoPE scaling other than ``none`` / ``linear`` / ``llama3`` / ``yarn``,
raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

from rrs_tpu_torch.ops.basic import ROPE_SCALING_TYPES

SUPPORTED_ARCHS = ("llama", "mistral", "qwen2", "qwen3", "qwen2moe", "qwen3moe", "gpt-oss",
                   "deepseek2", "gemma2", "gemma3", "granite", "minicpm", "olmo2", "phi3",
                   "mamba", "mamba2", "falcon_mamba", "rwkv6", "rwkv6qwen2", "jamba",
                   "qwen2vl")


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
    # DeepSeek-family routing: leading dense layers, routed-weight scale,
    # post-top-k weight norm, V3's expert-group restriction
    n_dense_lead: int = 0
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
    # MLA (deepseek2): low-rank q / kv projections; kv_lora_rank > 0 => MLA.
    # head_dim is the decompressed qk head size (nope + rope, e.g. 192),
    # v_head_dim the decompressed v size
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    rope_yarn_log_mul: float = 0.0   # mscale_all_dim (pre-multiplies the kq scale)
    # gemma / granite / minicpm / olmo2 / phi3
    attn_softcap: float = 0.0        # attention logit softcap (gemma2)
    final_softcap: float = 0.0       # final logit softcap (gemma2)
    attn_scale: float = 0.0          # 0 => 1 / sqrt(head_dim)
    embd_scale: float = 1.0          # token embeddings times it (gemma: sqrt(E))
    residual_scale: float = 1.0      # attention / FFN outputs times it (granite, minicpm)
    logits_divisor: float = 1.0      # logits divided by it (granite, minicpm)
    qk_norm_full: bool = False       # olmo2: q / k RMS over the whole projection
    post_norm_only: bool = False     # olmo2: no pre-norms; outputs normed before the add
    sandwich_norm: bool = False      # gemma2 / 3: post-attention and post-FFN norms
    ffn_act: str = "silu"            # "silu" | "gelu" (tanh-approximate GEGLU)
    rope_rot_dim: int = 0            # partial rotary (phi3); 0 => head_dim
    # recurrent (Mamba) sizes; falcon-mamba's weightless RMS norms on dt / B / C
    ssm_d_conv: int = 0
    ssm_d_inner: int = 0
    ssm_d_state: int = 0
    ssm_dt_rank: int = 0
    ssm_dt_b_c_rms: bool = False
    no_rope: bool = False            # jamba: attention layers without RoPE
    # RWKV6: head size, the low-rank lerp and decay widths, x halved every n layers
    rwkv_head_size: int = 0
    rwkv_tm_extra: int = 0
    rwkv_decay_extra: int = 0
    rwkv_rescale_every: int = 0
    # M-RoPE (qwen2vl): per-channel frequency-dim counts over rot / 2 (t, h,
    # w[, e]); () => plain RoPE
    rope_sections: tuple = ()
    # the plain attention instead of the flash kernels, on the card too:
    # training sets it (train/finetune.py), as the JAX package's does
    ref_attention: bool = False
    # set only on a tensor-parallel shard's local config
    # (parallel/sharding.py ``_local_cfg``): the shard's handle on its row's
    # collectives, over which the row-parallel products (wo, ffn_down, the
    # dense experts) sum, as JAX's mesh axis name does
    tp_axis: Any = None
    # set only on a training mesh's shard with ep > 1 (parallel/train_step.py):
    # the expert ids it holds and its handle on the (ep x tp) group of its dp
    # row (``sharding.ExpertComm``), over which the routed output sums
    ep_axis: Any = None

    @property
    def n_q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def n_kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_mla(self) -> bool:
        """Multi-head latent attention: the cache holds one compressed
        [rope | kv_lora_rank] row a position (the absorbed-MQA form)."""
        return self.kv_lora_rank > 0

    @property
    def qk_nope_dim(self) -> int:
        return self.head_dim - self.qk_rope_dim

    # cache geometry: MLA caches one head of [k_pe | c_kv] for K and c_kv
    # for V; everything else n_kv_heads of head_dim for both
    @property
    def kv_cache_heads(self) -> int:
        return 1 if self.is_mla else self.n_kv_heads

    @property
    def kv_k_dim(self) -> int:
        return self.qk_rope_dim + self.kv_lora_rank if self.is_mla else self.head_dim

    @property
    def kv_v_dim(self) -> int:
        return self.kv_lora_rank if self.is_mla else self.head_dim

    @property
    def is_hybrid(self) -> bool:
        """Attention and Mamba layers in one model (jamba)."""
        return self.arch == "jamba"

    @property
    def is_recurrent(self) -> bool:
        """Every layer recurrent (Mamba or RWKV6)."""
        return (self.ssm_d_inner > 0 or self.rwkv_head_size > 0) and not self.is_hybrid

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

        scaling = str(key("rope.scaling.type", "none") or "none")
        if scaling not in ROPE_SCALING_TYPES:
            raise NotImplementedError(f"rope scaling {scaling!r} is not ported to rrs_tpu_torch")
        n_embd = int(key("embedding_length"))
        n_heads = int(key("attention.head_count", 0) or 0)
        n_kv = int(key("attention.head_count_kv", n_heads) or 0)
        head_dim = int(key("attention.key_length",
                           n_embd // n_heads if n_heads else 0) or 0)
        vocab = md.get("tokenizer.ggml.tokens")
        vocab_size = int(key("vocab_size", len(vocab) if vocab is not None else 0))
        n_layers = int(key("block_count"))
        extra: dict = {}
        if arch == "gemma2":
            # pattern 2 with a 4096 default window, softcaps, GELU, sqrt(E)
            # embedding scale, sandwich norms; the 46-layer 27B scales the
            # scores by sqrt(E / n_heads)
            extra.update(
                swa_window=int(key("attention.sliding_window", 4096) or 4096),
                swa_pattern=2,
                attn_softcap=float(key("attn_logit_softcapping", 50.0) or 0.0),
                final_softcap=float(key("final_logit_softcapping", 30.0) or 0.0),
                ffn_act="gelu",
                embd_scale=float(n_embd) ** 0.5,
                sandwich_norm=True,
                attn_scale=(1.0 / (n_embd / n_heads) ** 0.5) if n_layers == 46
                else (1.0 / head_dim ** 0.5),
            )
        elif arch == "gemma3":
            # pattern 6, base 10k on sliding layers, q / k norms, GELU,
            # sandwich norms; the 62-layer 27B scales by sqrt(E / n_heads)
            win = int(key("attention.sliding_window", 0) or 0)
            extra.update(
                swa_window=win,
                swa_pattern=6 if win > 0 else 0,
                rope_theta_swa=float(key("rope.freq_base_swa", 10000.0) or 10000.0),
                final_softcap=float(key("final_logit_softcapping", 0.0) or 0.0),
                ffn_act="gelu",
                embd_scale=float(n_embd) ** 0.5,
                sandwich_norm=True,
                attn_scale=(1.0 / (n_embd / n_heads) ** 0.5) if n_layers == 62
                else (1.0 / head_dim ** 0.5),
            )
        elif arch == "granite":
            # the llama body with four scales: embeddings, attention / FFN
            # outputs, the kq scale and the logits divisor
            extra.update(
                embd_scale=float(key("embedding_scale", 1.0) or 1.0),
                residual_scale=float(key("residual_scale", 1.0) or 1.0),
                logits_divisor=float(key("logit_scale", 1.0) or 1.0),
                attn_scale=float(key("attention.scale", 0.0) or 0.0),
            )
        elif arch == "olmo2":
            # no pre-norms: the outputs are normed before the residual add;
            # q / k normed over the whole projection before the head reshape
            extra.update(qk_norm_full=True, post_norm_only=True)
        elif arch == "minicpm":
            # granite's scales with the defaults of older GGUFs
            res = 1.4 / math.sqrt(n_layers)
            extra.update(
                embd_scale=float(key("embedding_scale", 12.0) or 12.0),
                residual_scale=float(key("residual_scale", res) or res),
                logits_divisor=float(key("logit_scale", 256.0 / n_embd) or (256.0 / n_embd)),
            )
        elif arch == "gpt-oss":
            # alternating sliding layers (pattern 2, even layers), sinks,
            # biases, swiglu_oai experts and the post-top-k softmax
            extra.update(
                swa_window=int(key("attention.sliding_window", 128) or 128),
                swa_pattern=2,
                rope_theta_swa=float(key("rope.freq_base_swa", 0.0) or 0.0),
                expert_softmax_weight=True,
                moe_act="swiglu_oai",
            )
        elif arch in ("mistral", "llama", "phi3", "qwen2", "qwen3", "qwen2moe", "qwen3moe"):
            # llama / mistral / phi3 / qwen: every layer sliding when the key is present
            win = int(key("attention.sliding_window", 0) or 0)
            if win > 0:
                extra.update(swa_window=win, swa_pattern=1)
        if arch == "phi3":
            extra.update(rope_rot_dim=int(key("rope.dimension_count", 0) or 0))
        if arch == "deepseek2":
            # head_dim is the decompressed MLA head size when the *_mla keys
            # are present (files with split k_b / v_b write the cache row sizes
            # 576 / 512 under key_length / value_length); files with the
            # legacy wkv_b carry 192 under key_length itself
            k_mla = int(key("attention.key_length_mla", 0) or 0)
            v_mla = int(key("attention.value_length_mla", 0) or 0)
            if k_mla:
                head_dim = k_mla
            log_mul = float(key("rope.scaling.yarn_log_multiplier", 0.0) or 0.0)
            extra.update(
                q_lora_rank=int(key("attention.q_lora_rank", 0) or 0),
                kv_lora_rank=int(key("attention.kv_lora_rank", 0) or 0),
                qk_rope_dim=int(key("rope.dimension_count", 64) or 64),
                v_head_dim=v_mla or int(key("attention.value_length", head_dim) or head_dim),
                n_dense_lead=int(key("leading_dense_block_count", 0) or 0),
                expert_weights_scale=float(key("expert_weights_scale", 1.0) or 1.0),
                expert_weights_norm=bool(key("expert_weights_norm", False)),
                # the GGUF stores 0.1 * mscale_all_dim: cancel the 0.1
                rope_yarn_log_mul=log_mul / 0.1 if log_mul else 0.0,
                n_expert_groups=int(key("expert_group_count", 0) or 0),
                n_group_used=int(key("expert_group_used_count", 0) or 0),
                # V2 files predate the gating-function key: softmax
                expert_gating_softmax=int(key("expert_gating_func", 1) or 1) == 1,
            )
        if arch == "qwen2vl":
            sect = key("rope.dimension_sections")
            if sect is not None:
                extra.update(rope_sections=tuple(int(x) for x in sect))
        if arch == "jamba":
            extra.update(no_rope=True)
        if arch in ("rwkv6", "rwkv6qwen2"):
            extra.update(
                rwkv_head_size=int(key("wkv.head_size", 64) or 64),
                rwkv_tm_extra=int(key("time_mix_extra_dim", 32) or 32),
                rwkv_decay_extra=int(key("time_decay_extra_dim", 64) or 64),
                rwkv_rescale_every=int(key("rescale_every_n_layers", 0) or 0),
            )
        if arch in ("mamba", "mamba2", "falcon_mamba", "jamba"):
            dt_rank = -(-n_embd // 16)
            extra.update(
                ssm_d_conv=int(key("ssm.conv_kernel", 4) or 4),
                ssm_d_inner=int(key("ssm.inner_size", 2 * n_embd) or 2 * n_embd),
                ssm_d_state=int(key("ssm.state_size", 16) or 16),
                ssm_dt_rank=int(key("ssm.time_step_rank", dt_rank) or dt_rank),
                ssm_dt_b_c_rms=bool(key("ssm.dt_b_c_rms", False)),
            )
        return ModelConfig(
            **extra,
            arch=arch,
            n_layers=n_layers,
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
            # llama and granite weights are pre-permuted for interleaved (NORM) rope
            rope_neox=arch not in ("llama", "granite"),
            qk_norm=arch in ("qwen3", "qwen3moe", "gemma3", "olmo2"),
            attn_bias=arch in ("qwen2", "qwen2vl", "qwen2moe", "gpt-oss"),
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
    "gemma3-4b": ModelConfig(
        arch="gemma3", n_layers=34, n_embd=2560, n_heads=8, n_kv_heads=4,
        head_dim=256, n_ff=10240, vocab_size=262208, context_length=131072,
        rope_theta=1e6, rope_scaling_type="linear", rope_scale_factor=8.0,
        qk_norm=True, tie_embeddings=True,
        swa_window=1024, swa_pattern=6, rope_theta_swa=10000.0,
        ffn_act="gelu", embd_scale=2560.0 ** 0.5, sandwich_norm=True,
        attn_scale=1.0 / 256.0 ** 0.5,
    ),
    "gemma2-9b": ModelConfig(
        arch="gemma2", n_layers=42, n_embd=3584, n_heads=16, n_kv_heads=8,
        head_dim=256, n_ff=14336, vocab_size=256000, context_length=8192,
        rope_theta=10000.0, tie_embeddings=True,
        swa_window=4096, swa_pattern=2, attn_softcap=50.0, final_softcap=30.0,
        ffn_act="gelu", embd_scale=3584.0 ** 0.5, sandwich_norm=True,
        attn_scale=1.0 / 256.0 ** 0.5,
    ),
    "mistral-7b": ModelConfig(
        arch="llama", n_layers=32, n_embd=4096, n_heads=32, n_kv_heads=8,
        head_dim=128, n_ff=14336, vocab_size=32000, context_length=32768,
        rope_theta=10000.0, rope_neox=False,
        swa_window=4096, swa_pattern=1,
    ),
    "deepseek-v2-lite": ModelConfig(
        arch="deepseek2", n_layers=27, n_embd=2048, n_heads=16,
        n_kv_heads=1, head_dim=192, n_ff=10944, vocab_size=102400,
        context_length=163840, rope_theta=10000.0,
        rope_scaling_type="yarn", rope_scale_factor=40.0,
        rope_orig_context=4096, rope_yarn_log_mul=0.707,
        kv_lora_rank=512, qk_rope_dim=64, v_head_dim=128,
        n_dense_lead=1, n_experts=64, n_experts_used=6, n_ff_exp=1408,
    ),
    # MLA with a q LoRA and V3-style routing (sigmoid gating, selection
    # bias, expert groups)
    "tiny-mla": ModelConfig(
        arch="deepseek2", n_layers=3, n_embd=128, n_heads=4, n_kv_heads=1,
        head_dim=48, n_ff=256, vocab_size=512, context_length=1024,
        kv_lora_rank=64, q_lora_rank=48, qk_rope_dim=16, v_head_dim=32,
        n_dense_lead=1, n_experts=8, n_experts_used=2, n_ff_exp=64,
        expert_gating_softmax=False, expert_weights_norm=True,
        expert_weights_scale=2.5, n_expert_groups=4, n_group_used=2,
    ),
    "tiny": ModelConfig(
        arch="qwen3", n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2,
        head_dim=64, n_ff=512, vocab_size=512, context_length=1024,
        qk_norm=True, tie_embeddings=True,
    ),
}
