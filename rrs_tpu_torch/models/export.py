"""Export a model to GGUF (convert_hf_to_gguf / llama-model-saver analog).

Port of ``rrs_tpu/models/export.py``: ``export_random_gguf`` for every
configuration (dense, sliding-window, MoE with MXFP4 or plain expert
stacks, gpt-oss, MLA, sandwich norms, recurrent), with the same metadata
keys, tensor names and NumPy draw order, so that the same seed writes the
same bytes; and ``export_weights_gguf``, which writes the port's unfused
dense weights back. Tensor names follow the llama.cpp conventions
(llama-arch.cpp tensor templates).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from rrs_tpu_torch.gguf.writer import GGUFWriter
from rrs_tpu_torch.models.config import ModelConfig


def export_random_gguf(
    cfg: ModelConfig,
    path: str | Path,
    seed: int = 0,
    scale: float = 0.05,
    dtype=np.float32,
    vocab_tokens: list[str] | None = None,
    expert_ggml_type=None,
    vocab_model: str = "gpt2",
    vocab_scores: list[float] | None = None,
    vocab_types: list[int] | None = None,
):
    """Write a random-weight GGUF model matching ``cfg``.

    ``expert_ggml_type``: optional GGMLType for the stacked ``*_exps``
    expert tensors (e.g. MXFP4 — the gpt-oss native expert format); other
    tensors stay ``dtype``."""
    rng = np.random.default_rng(seed)
    w = GGUFWriter(path)
    a = cfg.arch
    w.add_string("general.architecture", a)
    w.add_string("general.name", f"random-{a}")
    w.add_uint32(f"{a}.block_count", cfg.n_layers)
    w.add_uint32(f"{a}.context_length", cfg.context_length)
    w.add_uint32(f"{a}.embedding_length", cfg.n_embd)
    w.add_uint32(f"{a}.feed_forward_length", cfg.n_ff)
    w.add_uint32(f"{a}.attention.head_count", cfg.n_heads)
    w.add_uint32(f"{a}.attention.head_count_kv", cfg.n_kv_heads)
    w.add_uint32(f"{a}.attention.key_length", cfg.head_dim)
    w.add_uint32(f"{a}.attention.value_length", cfg.head_dim)
    w.add_float32(f"{a}.attention.layer_norm_rms_epsilon", cfg.rms_eps)
    w.add_float32(f"{a}.rope.freq_base", cfg.rope_theta)
    w.add_uint32(f"{a}.vocab_size", cfg.vocab_size)
    if cfg.is_recurrent:
        w.add_uint32(f"{a}.ssm.conv_kernel", cfg.ssm_d_conv)
        w.add_uint32(f"{a}.ssm.inner_size", cfg.ssm_d_inner)
        w.add_uint32(f"{a}.ssm.state_size", cfg.ssm_d_state)
        w.add_uint32(f"{a}.ssm.time_step_rank", cfg.ssm_dt_rank)
    if cfg.swa_window:
        w.add_uint32(f"{a}.attention.sliding_window", cfg.swa_window)
    if cfg.n_experts:
        w.add_uint32(f"{a}.expert_count", cfg.n_experts)
        w.add_uint32(f"{a}.expert_used_count", cfg.n_experts_used)
        w.add_uint32(f"{a}.expert_feed_forward_length", cfg.n_ff_exp)
    if cfg.is_mla:
        # deepseek2: decompressed head sizes ride the *_mla keys; the plain
        # key/value_length keys carry the latent cache row sizes (matching
        # the modern split-k_b/v_b convert layout, llama-model.cpp:1712-1713)
        w.add_uint32(f"{a}.attention.key_length_mla", cfg.head_dim)
        w.add_uint32(f"{a}.attention.value_length_mla", cfg.v_head_dim)
        if cfg.q_lora_rank:
            w.add_uint32(f"{a}.attention.q_lora_rank", cfg.q_lora_rank)
        w.add_uint32(f"{a}.attention.kv_lora_rank", cfg.kv_lora_rank)
        w.add_uint32(f"{a}.rope.dimension_count", cfg.qk_rope_dim)
        w.add_uint32(f"{a}.leading_dense_block_count", cfg.n_dense_lead)
        if cfg.n_experts:
            w.add_uint32(f"{a}.expert_shared_count", 1)
            w.add_float32(f"{a}.expert_weights_scale",
                          cfg.expert_weights_scale)
            w.add_bool(f"{a}.expert_weights_norm", cfg.expert_weights_norm)
            w.add_uint32(f"{a}.expert_gating_func",
                         1 if cfg.expert_gating_softmax else 2)
            if cfg.n_expert_groups:
                w.add_uint32(f"{a}.expert_group_count", cfg.n_expert_groups)
                w.add_uint32(f"{a}.expert_group_used_count", cfg.n_group_used)
    if vocab_tokens is not None:
        w.add_string("tokenizer.ggml.model", vocab_model)
        w.add_array("tokenizer.ggml.tokens", vocab_tokens)
        if vocab_scores is not None:
            w.add_array("tokenizer.ggml.scores",
                        [float(s) for s in vocab_scores])
        if vocab_types is not None:
            w.add_array("tokenizer.ggml.token_type",
                        [int(t) for t in vocab_types])

    def t(name, shape):
        arr = (rng.standard_normal(shape) * scale).astype(dtype)
        if expert_ggml_type is not None and name.endswith("_exps.weight"):
            from rrs_tpu_torch.formats.kquants import quantize_mxfp4
            from rrs_tpu_torch.gguf.constants import GGMLType

            assert expert_ggml_type == GGMLType.MXFP4, expert_ggml_type
            w.add_tensor(name, quantize_mxfp4(arr.astype(np.float32)),
                         shape=shape, ggml_type=expert_ggml_type)
            return
        w.add_tensor(name, arr)

    def norm(name, n):
        w.add_tensor(name, np.ones((n,), dtype))

    e, hq, hkv, d, f = cfg.n_embd, cfg.n_q_dim, cfg.n_kv_dim, cfg.head_dim, cfg.n_ff
    t("token_embd.weight", (cfg.vocab_size, e))
    if cfg.is_recurrent:
        di, ds, dtr, dc = (cfg.ssm_d_inner, cfg.ssm_d_state,
                           cfg.ssm_dt_rank, cfg.ssm_d_conv)
        for i in range(cfg.n_layers):
            p = f"blk.{i}"
            norm(f"{p}.attn_norm.weight", e)
            t(f"{p}.ssm_in.weight", (2 * di, e))
            t(f"{p}.ssm_conv1d.weight", (di, dc))
            t(f"{p}.ssm_conv1d.bias", (di,))
            t(f"{p}.ssm_x.weight", (dtr + 2 * ds, di))
            t(f"{p}.ssm_dt.weight", (di, dtr))
            t(f"{p}.ssm_dt.bias", (di,))
            # ssm_a / ssm_d are suffix-less (llama-model.cpp:3907-3908)
            w.add_tensor(f"{p}.ssm_a",
                         (-np.exp(rng.standard_normal((di, ds)) * 0.5)
                          ).astype(dtype))
            w.add_tensor(f"{p}.ssm_d", np.ones((di,), dtype))
            t(f"{p}.ssm_out.weight", (e, di))
        norm("output_norm.weight", e)
        if not cfg.tie_embeddings:
            t("output.weight", (cfg.vocab_size, e))
        w.write()
        return Path(path)
    for i in range(cfg.n_layers):
        p = f"blk.{i}"
        norm(f"{p}.attn_norm.weight", e)
        if cfg.is_mla:
            # deepseek2 MLA tensors (llama-model.cpp:4941-4999); split
            # k_b/v_b factors in the modern GGUF shapes
            nope, rope_d, r = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
            if cfg.q_lora_rank:
                t(f"{p}.attn_q_a.weight", (cfg.q_lora_rank, e))
                norm(f"{p}.attn_q_a_norm.weight", cfg.q_lora_rank)
                t(f"{p}.attn_q_b.weight", (cfg.n_heads * d, cfg.q_lora_rank))
            else:
                t(f"{p}.attn_q.weight", (cfg.n_heads * d, e))
            t(f"{p}.attn_kv_a_mqa.weight", (r + rope_d, e))
            norm(f"{p}.attn_kv_a_norm.weight", r)
            t(f"{p}.attn_k_b.weight", (cfg.n_heads, r, nope))
            t(f"{p}.attn_v_b.weight", (cfg.n_heads, cfg.v_head_dim, r))
            t(f"{p}.attn_output.weight", (e, cfg.n_heads * cfg.v_head_dim))
        else:
            t(f"{p}.attn_q.weight", (hq, e))
            t(f"{p}.attn_k.weight", (hkv, e))
            t(f"{p}.attn_v.weight", (hkv, e))
            t(f"{p}.attn_output.weight", (e, hq))
            if cfg.attn_bias:
                t(f"{p}.attn_q.bias", (hq,))
                t(f"{p}.attn_k.bias", (hkv,))
                t(f"{p}.attn_v.bias", (hkv,))
        if cfg.arch == "gpt-oss":
            # gpt-oss: output bias, per-head sinks, and the pre-FFN norm
            # under the post_attention_norm name (llama-model.cpp:6520-6540)
            t(f"{p}.attn_output.bias", (e,))
            t(f"{p}.attn_sinks.weight", (cfg.n_heads,))
        if cfg.qk_norm:
            norm(f"{p}.attn_q_norm.weight", d)
            norm(f"{p}.attn_k_norm.weight", d)
        if cfg.arch == "gpt-oss":
            norm(f"{p}.post_attention_norm.weight", e)
        else:
            norm(f"{p}.ffn_norm.weight", e)
        if cfg.is_mla and i < cfg.n_dense_lead:
            t(f"{p}.ffn_gate.weight", (f, e))
            t(f"{p}.ffn_up.weight", (f, e))
            t(f"{p}.ffn_down.weight", (e, f))
        elif cfg.n_experts:
            # MoE: router + stacked expert tensors (llama.cpp *_exps layout:
            # gate/up [E, F, K_in], down [E, K_out, F])
            fe = cfg.n_ff_exp
            t(f"{p}.ffn_gate_inp.weight", (cfg.n_experts, e))
            t(f"{p}.ffn_gate_exps.weight", (cfg.n_experts, fe, e))
            t(f"{p}.ffn_up_exps.weight", (cfg.n_experts, fe, e))
            t(f"{p}.ffn_down_exps.weight", (cfg.n_experts, e, fe))
            if cfg.is_mla:
                # deepseek2 MoE layers carry a shared expert; V3-style
                # sigmoid gating also gets the selection bias
                t(f"{p}.ffn_gate_shexp.weight", (fe, e))
                t(f"{p}.ffn_up_shexp.weight", (fe, e))
                t(f"{p}.ffn_down_shexp.weight", (e, fe))
                if not cfg.expert_gating_softmax:
                    t(f"{p}.exp_probs_b.bias", (cfg.n_experts,))
            if cfg.arch == "gpt-oss":
                # router + per-expert biases (llama-model.cpp:6541-6545)
                t(f"{p}.ffn_gate_inp.bias", (cfg.n_experts,))
                t(f"{p}.ffn_gate_exps.bias", (cfg.n_experts, fe))
                t(f"{p}.ffn_up_exps.bias", (cfg.n_experts, fe))
                t(f"{p}.ffn_down_exps.bias", (cfg.n_experts, e))
        else:
            t(f"{p}.ffn_gate.weight", (f, e))
            t(f"{p}.ffn_up.weight", (f, e))
            t(f"{p}.ffn_down.weight", (e, f))
        if cfg.sandwich_norm:
            norm(f"{p}.post_attention_norm.weight", e)
            norm(f"{p}.post_ffw_norm.weight", e)
    norm("output_norm.weight", e)
    if not cfg.tie_embeddings:
        t("output.weight", (cfg.vocab_size, e))
    w.write()
    return Path(path)


def _f32(t) -> np.ndarray:
    """A torch tensor (any dtype, any device) as a host f32 array."""
    return t.detach().to(torch.float32).cpu().numpy()


def export_weights_gguf(cfg: ModelConfig, weights, path: str | Path,
                        metadata: dict | None = None):
    """Write a ModelWeights back to GGUF, the llama-model-saver analog.
    Dense layers only; requires weights loaded with fuse=False."""
    from rrs_tpu_torch.models.linear import DenseLinear

    w = GGUFWriter(path)
    if metadata:
        for k, v in metadata.items():
            w.add_kv(k, v)

    def put(name, arr):
        w.add_tensor(name, _f32(arr))

    def put_lin(name, lin):
        if lin is None:
            return
        if not isinstance(lin, DenseLinear):
            raise ValueError(
                f"{name}: only dense layers can be re-exported (got "
                f"{type(lin).__name__}); train an F32/F16 model")
        put(name, lin.w.T)                             # [K,N] -> [N,K]
        if lin.bias is not None:
            put(name.replace(".weight", ".bias"), lin.bias)

    emb = weights.embed
    if isinstance(emb, tuple):                         # Q8-packed table
        q, s = (e.to(torch.float32) for e in emb)
        emb = (q.reshape(q.shape[0], -1, 32) * s[..., None]).reshape(q.shape[0], -1)
    put("token_embd.weight", emb)
    for i, lw in enumerate(weights.layers):
        p = f"blk.{i}"
        put(f"{p}.attn_norm.weight", lw.attn_norm)
        put_lin(f"{p}.attn_q.weight", lw.wq)
        put_lin(f"{p}.attn_k.weight", lw.wk)
        put_lin(f"{p}.attn_v.weight", lw.wv)
        put_lin(f"{p}.attn_output.weight", lw.wo)
        if lw.q_norm is not None:
            put(f"{p}.attn_q_norm.weight", lw.q_norm)
            put(f"{p}.attn_k_norm.weight", lw.k_norm)
        put(f"{p}.ffn_norm.weight", lw.ffn_norm)
        put_lin(f"{p}.ffn_gate.weight", lw.w_gate)
        put_lin(f"{p}.ffn_up.weight", lw.w_up)
        put_lin(f"{p}.ffn_down.weight", lw.w_down)
        if lw.attn_post_norm is not None:
            put(f"{p}.post_attention_norm.weight", lw.attn_post_norm)
        if lw.ffn_post_norm is not None:
            put(f"{p}.post_ffw_norm.weight", lw.ffn_post_norm)
    put("output_norm.weight", weights.final_norm)
    if not cfg.tie_embeddings and isinstance(weights.lm_head, DenseLinear):
        put("output.weight", weights.lm_head.w.T)
    w.write()
    return Path(path)
