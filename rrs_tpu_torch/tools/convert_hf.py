"""HF checkpoint -> GGUF converter (convert_hf_to_gguf.py analog).

Port of ``convert_hf_to_gguf`` and its helpers in
``rrs_tpu/tools/convert_hf.py``: reads a local HuggingFace model directory
(config.json + *.safetensors or pytorch_model*.bin) and writes an F32/F16
GGUF with llama.cpp tensor names and metadata keys, the same bytes as the
JAX package's converter on the same weights. Safetensors files are read by
the port's own reader (``tools/safetensors_io.py``; no ``safetensors``
package), which decodes BF16, the dtype most checkpoints ship in, exactly to
f32 (the JAX converter reads through ``safe_open(framework="np")``, which
cannot hold BF16); ``.bin`` files go through ``torch.load(weights_only=True)``.

Covered architectures: llama / mistral, granite, olmo2, qwen2, qwen3,
qwen2moe, qwen3moe, gemma2, gemma3, mamba, deepseek2 (V2 / V3), gpt-oss,
phi3 and the qwen2vl text stack. The vision tower's mmproj extraction
(``convert-hf --mmproj``) waits for ROADMAP A11.

Key conversion details mirrored from the reference converter:
  * llama/mistral q/k weights are PERMUTED for interleaved (NORM) rope
    (LlamaModel.permute in convert_hf_to_gguf.py).
  * gemma norm weights are stored +1 (Gemma2Model/Gemma3Model modify_tensors).
  * tokenizer: BPE vocab + merges exported from tokenizer.json (fast
    tokenizer); sentencepiece models need the `tokenizer.json` variant since
    the sentencepiece package is not available here.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from rrs_tpu_torch.gguf.writer import GGUFWriter


def _load_state_dict(model_dir: Path) -> dict:
    tensors = {}
    st_files = sorted(model_dir.glob("*.safetensors"))
    if st_files:
        from rrs_tpu_torch.tools.safetensors_io import load_safetensors

        for f in st_files:
            tensors.update(load_safetensors(f))
        return tensors
    bins = sorted(model_dir.glob("pytorch_model*.bin")) \
        or sorted(model_dir.glob("*.pt"))
    if not bins:
        raise FileNotFoundError(f"no safetensors or .bin weights in {model_dir}")
    import torch

    for f in bins:
        sd = torch.load(str(f), map_location="cpu", weights_only=True)
        for k, v in sd.items():
            tensors[k] = v.float().numpy()
    return tensors


def _permute_rope(w: np.ndarray, n_head: int) -> np.ndarray:
    """llama interleaved-rope permutation (convert_hf_to_gguf LlamaModel.permute)."""
    out_dim = w.shape[0]
    return (w.reshape(n_head, 2, out_dim // n_head // 2, *w.shape[1:])
            .swapaxes(1, 2)
            .reshape(w.shape))


_ARCH_MAP = {
    "LlamaForCausalLM": "llama",
    "MistralForCausalLM": "llama",
    "GraniteForCausalLM": "granite",
    "Olmo2ForCausalLM": "olmo2",
    "Qwen2ForCausalLM": "qwen2",
    "Qwen3ForCausalLM": "qwen3",
    "Qwen2MoeForCausalLM": "qwen2moe",
    "Qwen3MoeForCausalLM": "qwen3moe",
    "Gemma2ForCausalLM": "gemma2",
    "Gemma3ForCausalLM": "gemma3",
    "Gemma3ForConditionalGeneration": "gemma3",
    "MambaForCausalLM": "mamba",
    "DeepseekV2ForCausalLM": "deepseek2",
    "DeepseekV3ForCausalLM": "deepseek2",
    "GptOssForCausalLM": "gpt-oss",
    "Phi3ForCausalLM": "phi3",
    "Qwen2VLForConditionalGeneration": "qwen2vl",
    # 2.5's LLM is the same qwen2vl text stack (M-RoPE sections; the
    # vision differences live entirely in the mmproj)
    "Qwen2_5_VLForConditionalGeneration": "qwen2vl",
}


def _export_tokenizer(w: GGUFWriter, model_dir: Path):
    tj = model_dir / "tokenizer.json"
    if not tj.exists():
        return False
    data = json.loads(tj.read_text())
    model = data.get("model", {})
    if model.get("type") != "BPE":
        # unigram/wordpiece would need score export; BPE covers qwen/llama3/gpt2
        return False
    vocab = model.get("vocab", {})
    tokens = [None] * len(vocab)
    for tok, tid in vocab.items():
        if tid < len(tokens):
            tokens[tid] = tok
    added = data.get("added_tokens", [])
    max_id = max([len(tokens) - 1] + [a["id"] for a in added]) if added else len(tokens) - 1
    if max_id >= len(tokens):
        tokens.extend([None] * (max_id + 1 - len(tokens)))
    ttypes = [1] * len(tokens)            # NORMAL
    for a in added:
        tokens[a["id"]] = a["content"]
        ttypes[a["id"]] = 3               # CONTROL
    tokens = [t if t is not None else f"<unused{i}>" for i, t in enumerate(tokens)]
    merges = model.get("merges", [])
    merges = [m if isinstance(m, str) else " ".join(m) for m in merges]
    w.add_string("tokenizer.ggml.model", "gpt2")
    w.add_string("tokenizer.ggml.pre", "default")
    w.add_array("tokenizer.ggml.tokens", tokens)
    w.add_array("tokenizer.ggml.token_type", ttypes)
    w.add_array("tokenizer.ggml.merges", merges)
    cfg_file = model_dir / "tokenizer_config.json"
    gc = model_dir / "generation_config.json"
    bos = eos = None
    if gc.exists():
        g = json.loads(gc.read_text())
        bos, eos = g.get("bos_token_id"), g.get("eos_token_id")
        if isinstance(eos, list):
            eos = eos[0]
    if cfg_file.exists() and (bos is None or eos is None):
        tc = json.loads(cfg_file.read_text())
        tok_to_id = {t: i for i, t in enumerate(tokens)}

        def tid(key):
            v = tc.get(key)
            if isinstance(v, dict):
                v = v.get("content")
            return tok_to_id.get(v) if isinstance(v, str) else None

        bos = bos if bos is not None else tid("bos_token")
        eos = eos if eos is not None else tid("eos_token")
    if bos is not None:
        w.add_uint32("tokenizer.ggml.bos_token_id", int(bos))
    if eos is not None:
        w.add_uint32("tokenizer.ggml.eos_token_id", int(eos))
    if cfg_file.exists():
        tc = json.loads(cfg_file.read_text())
        if tc.get("chat_template"):
            w.add_string("tokenizer.chat_template", str(tc["chat_template"]))
    return True


def convert_hf_to_gguf(model_dir: str | Path, out_path: str | Path,
                       out_dtype=np.float32) -> Path:
    model_dir = Path(model_dir)
    cfg = json.loads((model_dir / "config.json").read_text())
    if cfg.get("model_type") == "gemma3" and "text_config" in cfg:
        arch_list = cfg.get("architectures", [])
        cfg = {**cfg["text_config"], "architectures": arch_list}
    elif "text_config" in cfg:
        # VLM configs (qwen2_vl): LLM params live top-level AND nested;
        # pull up anything only present in text_config (e.g. rope_theta)
        cfg = {**cfg, **{k: v for k, v in cfg["text_config"].items()
                         if k not in cfg}}
    arch_name = (cfg.get("architectures") or ["?"])[0]
    if arch_name not in _ARCH_MAP:
        raise ValueError(f"unsupported architecture {arch_name}; "
                         f"supported: {sorted(_ARCH_MAP)}")
    a = _ARCH_MAP[arch_name]
    sd = _load_state_dict(model_dir)

    n_layers = cfg["num_hidden_layers"]
    n_embd = cfg["hidden_size"]
    w = GGUFWriter(out_path)
    w.add_string("general.architecture", a)
    w.add_string("general.name", model_dir.name)
    w.add_uint32(f"{a}.block_count", n_layers)
    w.add_uint32(f"{a}.context_length", cfg.get("max_position_embeddings", 4096))
    w.add_uint32(f"{a}.embedding_length", n_embd)
    w.add_uint32(f"{a}.vocab_size", cfg["vocab_size"])

    if a == "mamba":
        w.add_uint32(f"{a}.ssm.conv_kernel", cfg.get("conv_kernel", 4))
        w.add_uint32(f"{a}.ssm.inner_size",
                     cfg.get("intermediate_size", 2 * n_embd))
        w.add_uint32(f"{a}.ssm.state_size", cfg.get("state_size", 16))
        dt_rank = cfg.get("time_step_rank")
        if dt_rank in (None, "auto"):
            dt_rank = -(-n_embd // 16)
        w.add_uint32(f"{a}.ssm.time_step_rank", int(dt_rank))
        w.add_float32(f"{a}.attention.layer_norm_rms_epsilon",
                      cfg.get("layer_norm_epsilon", 1e-5))
    elif a == "deepseek2":
        # MLA converts into MQA over the latent row (reference
        # convert_hf_to_gguf.py DeepseekV2Model.set_gguf_parameters):
        # key/value_length carry the latent cache row sizes, the *_mla
        # keys the decompressed head sizes
        n_heads = cfg["num_attention_heads"]
        nope, rope_d = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
        r = cfg["kv_lora_rank"]
        w.add_uint32(f"{a}.feed_forward_length", cfg["intermediate_size"])
        w.add_uint32(f"{a}.attention.head_count", n_heads)
        w.add_uint32(f"{a}.attention.head_count_kv", 1)
        w.add_uint32(f"{a}.attention.key_length", r + rope_d)
        w.add_uint32(f"{a}.attention.value_length", r)
        w.add_uint32(f"{a}.attention.key_length_mla", nope + rope_d)
        w.add_uint32(f"{a}.attention.value_length_mla", cfg["v_head_dim"])
        if cfg.get("q_lora_rank"):
            w.add_uint32(f"{a}.attention.q_lora_rank", cfg["q_lora_rank"])
        w.add_uint32(f"{a}.attention.kv_lora_rank", r)
        w.add_uint32(f"{a}.rope.dimension_count", rope_d)
        w.add_float32(f"{a}.attention.layer_norm_rms_epsilon",
                      cfg.get("rms_norm_eps", 1e-6))
        w.add_float32(f"{a}.rope.freq_base", cfg.get("rope_theta", 10000.0))
        n_dense = cfg.get("first_k_dense_replace")
        if n_dense is None:
            n_dense = 0 if cfg.get("n_routed_experts") else n_layers
        w.add_uint32(f"{a}.leading_dense_block_count", n_dense)
        if cfg.get("n_routed_experts"):
            w.add_uint32(f"{a}.expert_count", cfg["n_routed_experts"])
            w.add_uint32(f"{a}.expert_used_count",
                         cfg["num_experts_per_tok"] or 1)
            w.add_uint32(f"{a}.expert_feed_forward_length",
                         cfg["moe_intermediate_size"])
            w.add_uint32(f"{a}.expert_shared_count",
                         cfg.get("n_shared_experts") or 0)
            w.add_float32(f"{a}.expert_weights_scale",
                          cfg.get("routed_scaling_factor", 1.0))
            w.add_bool(f"{a}.expert_weights_norm",
                       bool(cfg.get("norm_topk_prob", False)))
            w.add_uint32(f"{a}.expert_gating_func",
                         2 if cfg.get("scoring_func") == "sigmoid" else 1)
            if cfg.get("topk_method") in ("group_limited_greedy", "noaux_tc") \
                    and cfg.get("n_group"):
                w.add_uint32(f"{a}.expert_group_count", cfg["n_group"])
                w.add_uint32(f"{a}.expert_group_used_count",
                             cfg.get("topk_group", 1))
        rs = cfg.get("rope_scaling") or {}
        if rs.get("type") == "yarn" or rs.get("rope_type") == "yarn":
            w.add_string(f"{a}.rope.scaling.type", "yarn")
            w.add_float32(f"{a}.rope.scaling.factor", rs.get("factor", 1.0))
            w.add_uint32(f"{a}.rope.scaling.original_context_length",
                         rs.get("original_max_position_embeddings", 4096))
            if rs.get("mscale_all_dim") is not None:
                # the 0.1 factor is the convert-script legacy convention
                # ([TAG_DEEPSEEK2_YARN_LOG_MUL_FIX])
                w.add_float32(f"{a}.rope.scaling.yarn_log_multiplier",
                              0.1 * rs["mscale_all_dim"])
    else:
        n_heads = cfg["num_attention_heads"]
        n_kv = cfg.get("num_key_value_heads", n_heads)
        head_dim = cfg.get("head_dim", n_embd // n_heads)
        w.add_uint32(f"{a}.feed_forward_length", cfg["intermediate_size"])
        w.add_uint32(f"{a}.attention.head_count", n_heads)
        w.add_uint32(f"{a}.attention.head_count_kv", n_kv)
        w.add_uint32(f"{a}.attention.key_length", head_dim)
        w.add_uint32(f"{a}.attention.value_length", head_dim)
        w.add_float32(f"{a}.attention.layer_norm_rms_epsilon",
                      cfg.get("rms_norm_eps", 1e-6))
        w.add_float32(f"{a}.rope.freq_base", cfg.get("rope_theta", 10000.0))
        if cfg.get("sliding_window") and a in ("gemma2", "gemma3", "llama",
                                               "qwen2", "qwen3", "gpt-oss",
                                               "phi3"):
            w.add_uint32(f"{a}.attention.sliding_window", cfg["sliding_window"])
        if a == "phi3":
            # partial rotary + LongRoPE factors (Phi3Model in the reference
            # convert script; rope_factors_{long,short}.weight tensors)
            rot = int(head_dim * cfg.get("partial_rotary_factor", 1.0))
            w.add_uint32(f"{a}.rope.dimension_count", rot)
            rs = cfg.get("rope_scaling") or {}
            if rs.get("type") == "longrope" or rs.get("rope_type") == "longrope":
                w.add_string(f"{a}.rope.scaling.type", "longrope")
                w.add_uint32(f"{a}.rope.scaling.original_context_length",
                             cfg.get("original_max_position_embeddings",
                                     4096))
        if a == "gpt-oss":
            w.add_uint32(f"{a}.expert_count", cfg["num_local_experts"])
            w.add_uint32(f"{a}.expert_used_count", cfg["num_experts_per_tok"])
            w.add_uint32(f"{a}.expert_feed_forward_length",
                         cfg["intermediate_size"])
            rs = cfg.get("rope_scaling") or {}
            if rs.get("rope_type") == "yarn" or rs.get("type") == "yarn":
                w.add_string(f"{a}.rope.scaling.type", "yarn")
                w.add_float32(f"{a}.rope.scaling.factor",
                              rs.get("factor", 1.0))
                w.add_uint32(f"{a}.rope.scaling.original_context_length",
                             rs.get("original_max_position_embeddings", 4096))
        if a == "gemma2":
            w.add_float32(f"{a}.attn_logit_softcapping",
                          cfg.get("attn_logit_softcapping", 50.0))
            w.add_float32(f"{a}.final_logit_softcapping",
                          cfg.get("final_logit_softcapping", 30.0))
        if a == "granite":
            # GraniteConfig multipliers (llama-arch.cpp KV names)
            w.add_float32(f"{a}.embedding_scale",
                          float(cfg.get("embedding_multiplier", 1.0)))
            w.add_float32(f"{a}.residual_scale",
                          float(cfg.get("residual_multiplier", 1.0)))
            w.add_float32(f"{a}.logit_scale",
                          float(cfg.get("logits_scaling", 1.0)))
            w.add_float32(f"{a}.attention.scale",
                          float(cfg.get("attention_multiplier", 0.0)))
        if a == "qwen2vl":
            # M-RoPE sections (Qwen2VLModel.set_gguf_parameters in the
            # reference converter: rope_scaling.mrope_section padded to 4)
            rs = cfg.get("rope_scaling") or {}
            sect = list(rs.get("mrope_section") or [])
            if sect:
                sect = (sect + [0] * 4)[:4]
                w.add_array(f"{a}.rope.dimension_sections", sect)
        rs = cfg.get("rope_scaling") or {}
        if rs.get("rope_type") == "llama3" or rs.get("type") == "llama3":
            w.add_string(f"{a}.rope.scaling.type", "llama3")
            w.add_float32(f"{a}.rope.scaling.factor", rs.get("factor", 8.0))
            w.add_uint32(f"{a}.rope.scaling.original_context_length",
                         rs.get("original_max_position_embeddings", 8192))
    tie = bool(cfg.get("tie_word_embeddings", False))
    w.add_bool(f"{a}.tie_word_embeddings", tie)

    _export_tokenizer(w, model_dir)

    def put(name: str, arr: np.ndarray):
        w.add_tensor(name, np.ascontiguousarray(arr.astype(out_dtype)))

    gemma = a in ("gemma2", "gemma3")

    def put_norm(name: str, arr: np.ndarray):
        # gemma stores norm weights +1 in GGUF (Gemma2Model.modify_tensors)
        put(name, arr + 1.0 if gemma else arr)

    pfx = ""
    for cand in ("model.", "backbone."):
        if any(k.startswith(cand) for k in sd):
            pfx = cand
            break
    if f"{pfx}language_model.embed_tokens.weight" in sd:
        # VLM checkpoints (newer transformers layout) nest the text model
        pfx += "language_model."
    if a == "mamba":
        emb = sd[f"{pfx}embeddings.weight"] if f"{pfx}embeddings.weight" in sd \
            else sd[f"{pfx}embed_tokens.weight"]
        put("token_embd.weight", emb)
        for i in range(n_layers):
            hp = f"{pfx}layers.{i}."
            gp = f"blk.{i}."
            put_norm(gp + "attn_norm.weight", sd[hp + "norm.weight"])
            put(gp + "ssm_in.weight", sd[hp + "mixer.in_proj.weight"])
            conv_w = sd[hp + "mixer.conv1d.weight"]      # [di, 1, d_conv]
            put(gp + "ssm_conv1d.weight", conv_w[:, 0, :])
            put(gp + "ssm_conv1d.bias", sd[hp + "mixer.conv1d.bias"])
            put(gp + "ssm_x.weight", sd[hp + "mixer.x_proj.weight"])
            put(gp + "ssm_dt.weight", sd[hp + "mixer.dt_proj.weight"])
            put(gp + "ssm_dt.bias", sd[hp + "mixer.dt_proj.bias"])
            put(f"blk.{i}.ssm_a", -np.exp(sd[hp + "mixer.A_log"]))
            put(f"blk.{i}.ssm_d", sd[hp + "mixer.D"])
            put(gp + "ssm_out.weight", sd[hp + "mixer.out_proj.weight"])
        put_norm("output_norm.weight", sd[f"{pfx}norm_f.weight"])
        if not tie and "lm_head.weight" in sd:
            put("output.weight", sd["lm_head.weight"])
        w.write()
        return Path(out_path)

    if a == "deepseek2":
        nope, v_dim = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
        put("token_embd.weight", sd[f"{pfx}embed_tokens.weight"])
        for i in range(n_layers):
            hp = f"{pfx}layers.{i}."
            gp = f"blk.{i}."
            put_norm(gp + "attn_norm.weight",
                     sd[hp + "input_layernorm.weight"])
            if hp + "self_attn.q_a_proj.weight" in sd:
                put(gp + "attn_q_a.weight", sd[hp + "self_attn.q_a_proj.weight"])
                put_norm(gp + "attn_q_a_norm.weight",
                         sd[hp + "self_attn.q_a_layernorm.weight"])
                put(gp + "attn_q_b.weight", sd[hp + "self_attn.q_b_proj.weight"])
            else:
                put(gp + "attn_q.weight", sd[hp + "self_attn.q_proj.weight"])
            put(gp + "attn_kv_a_mqa.weight",
                sd[hp + "self_attn.kv_a_proj_with_mqa.weight"])
            put_norm(gp + "attn_kv_a_norm.weight",
                     sd[hp + "self_attn.kv_a_layernorm.weight"])
            # split kv_b into the absorption factors, k_b transposed
            # (reference convert DeepseekV2Model.modify_tensors)
            kv_b = sd[hp + "self_attn.kv_b_proj.weight"]
            kv_b = kv_b.reshape(-1, nope + v_dim, kv_b.shape[-1])  # [H,n+v,r]
            put(gp + "attn_k_b.weight",
                kv_b[:, :nope, :].transpose(0, 2, 1))              # [H,r,nope]
            put(gp + "attn_v_b.weight", kv_b[:, nope:, :])         # [H,v,r]
            put(gp + "attn_output.weight", sd[hp + "self_attn.o_proj.weight"])
            put_norm(gp + "ffn_norm.weight",
                     sd[hp + "post_attention_layernorm.weight"])
            if hp + "mlp.gate_proj.weight" in sd:                  # dense lead
                put(gp + "ffn_gate.weight", sd[hp + "mlp.gate_proj.weight"])
                put(gp + "ffn_up.weight", sd[hp + "mlp.up_proj.weight"])
                put(gp + "ffn_down.weight", sd[hp + "mlp.down_proj.weight"])
            else:
                put(gp + "ffn_gate_inp.weight", sd[hp + "mlp.gate.weight"])
                if hp + "mlp.gate.e_score_correction_bias" in sd:
                    put(gp + "exp_probs_b.bias",
                        sd[hp + "mlp.gate.e_score_correction_bias"])
                ne = cfg["n_routed_experts"]
                for w_name, g_name in (("gate_proj", "ffn_gate_exps"),
                                       ("up_proj", "ffn_up_exps"),
                                       ("down_proj", "ffn_down_exps")):
                    stack = np.stack([
                        sd[hp + f"mlp.experts.{xi}.{w_name}.weight"]
                        for xi in range(ne)])
                    put(gp + f"{g_name}.weight", stack)
                for w_name, g_name in (("gate_proj", "ffn_gate_shexp"),
                                       ("up_proj", "ffn_up_shexp"),
                                       ("down_proj", "ffn_down_shexp")):
                    put(gp + f"{g_name}.weight",
                        sd[hp + f"mlp.shared_experts.{w_name}.weight"])
        put_norm("output_norm.weight", sd[f"{pfx}norm.weight"])
        if not tie and "lm_head.weight" in sd:
            put("output.weight", sd["lm_head.weight"])
        w.write()
        return Path(out_path)

    if a == "phi3":
        # HF Phi3 ships qkv_proj / gate_up_proj PRE-fused in exactly the
        # GGUF attn_qkv / ffn_up layouts (q|k|v rows; gate|up rows consumed
        # as LLM_FFN_SWIGLU) — written through unchanged
        put("token_embd.weight", sd[f"{pfx}embed_tokens.weight"])
        for i in range(n_layers):
            hp = f"{pfx}layers.{i}."
            gp = f"blk.{i}."
            put_norm(gp + "attn_norm.weight",
                     sd[hp + "input_layernorm.weight"])
            put(gp + "attn_qkv.weight", sd[hp + "self_attn.qkv_proj.weight"])
            put(gp + "attn_output.weight", sd[hp + "self_attn.o_proj.weight"])
            put_norm(gp + "ffn_norm.weight",
                     sd[hp + "post_attention_layernorm.weight"])
            put(gp + "ffn_up.weight", sd[hp + "mlp.gate_up_proj.weight"])
            put(gp + "ffn_down.weight", sd[hp + "mlp.down_proj.weight"])
        rs = cfg.get("rope_scaling") or {}
        if rs.get("long_factor"):
            put("rope_factors_long.weight",
                np.asarray(rs["long_factor"], np.float32))
            put("rope_factors_short.weight",
                np.asarray(rs["short_factor"], np.float32))
        put_norm("output_norm.weight", sd[f"{pfx}norm.weight"])
        if not tie and "lm_head.weight" in sd:
            put("output.weight", sd["lm_head.weight"])
        w.write()
        return Path(out_path)

    if a == "gpt-oss":
        # HF GptOss (modeling_gpt_oss.py): experts as fused INTERLEAVED
        # gate_up_proj [E, hidden, 2*fe] (gate = [..., ::2], up = [..., 1::2])
        # in einsum orientation (input dim second), down_proj [E, fe, hidden];
        # per-head sink logits under self_attn.sinks; the pre-FFN norm ships
        # as post_attention_layernorm (GGUF post_attention_norm)
        put("token_embd.weight", sd[f"{pfx}embed_tokens.weight"])
        for i in range(n_layers):
            hp = f"{pfx}layers.{i}."
            gp = f"blk.{i}."
            put_norm(gp + "attn_norm.weight",
                     sd[hp + "input_layernorm.weight"])
            for nm in ("q", "k", "v"):
                put(gp + f"attn_{nm}.weight",
                    sd[hp + f"self_attn.{nm}_proj.weight"])
                put(gp + f"attn_{nm}.bias",
                    sd[hp + f"self_attn.{nm}_proj.bias"])
            put(gp + "attn_output.weight", sd[hp + "self_attn.o_proj.weight"])
            put(gp + "attn_output.bias", sd[hp + "self_attn.o_proj.bias"])
            put(gp + "attn_sinks.weight", sd[hp + "self_attn.sinks"])
            put_norm(gp + "post_attention_norm.weight",
                     sd[hp + "post_attention_layernorm.weight"])
            put(gp + "ffn_gate_inp.weight", sd[hp + "mlp.router.weight"])
            put(gp + "ffn_gate_inp.bias", sd[hp + "mlp.router.bias"])
            gu = sd[hp + "mlp.experts.gate_up_proj"]        # [E, K, 2F]
            gub = sd[hp + "mlp.experts.gate_up_proj_bias"]  # [E, 2F]
            put(gp + "ffn_gate_exps.weight", gu[..., ::2].transpose(0, 2, 1))
            put(gp + "ffn_up_exps.weight", gu[..., 1::2].transpose(0, 2, 1))
            put(gp + "ffn_gate_exps.bias", gub[..., ::2])
            put(gp + "ffn_up_exps.bias", gub[..., 1::2])
            dn = sd[hp + "mlp.experts.down_proj"]           # [E, F, K]
            put(gp + "ffn_down_exps.weight", dn.transpose(0, 2, 1))
            put(gp + "ffn_down_exps.bias",
                sd[hp + "mlp.experts.down_proj_bias"])
        put_norm("output_norm.weight", sd[f"{pfx}norm.weight"])
        if not tie and "lm_head.weight" in sd:
            put("output.weight", sd["lm_head.weight"])
        w.write()
        return Path(out_path)

    put("token_embd.weight", sd[f"{pfx}embed_tokens.weight"])
    for i in range(n_layers):
        hp = f"{pfx}layers.{i}."
        gp = f"blk.{i}."
        if a != "olmo2":     # olmo2 is post-norm-only (no input_layernorm)
            put_norm(gp + "attn_norm.weight",
                     sd[hp + "input_layernorm.weight"])
        wq = sd[hp + "self_attn.q_proj.weight"]
        wk = sd[hp + "self_attn.k_proj.weight"]
        if a in ("llama", "granite"):
            wq = _permute_rope(wq, n_heads)
            wk = _permute_rope(wk, n_kv)
        put(gp + "attn_q.weight", wq)
        put(gp + "attn_k.weight", wk)
        put(gp + "attn_v.weight", sd[hp + "self_attn.v_proj.weight"])
        put(gp + "attn_output.weight", sd[hp + "self_attn.o_proj.weight"])
        for b_name in ("q", "k", "v"):
            hb = hp + f"self_attn.{b_name}_proj.bias"
            if hb in sd:
                put(gp + f"attn_{b_name}.bias", sd[hb])
        if hp + "self_attn.q_norm.weight" in sd:
            put_norm(gp + "attn_q_norm.weight", sd[hp + "self_attn.q_norm.weight"])
            put_norm(gp + "attn_k_norm.weight", sd[hp + "self_attn.k_norm.weight"])
        if hp + "post_attention_layernorm.weight" in sd and gemma:
            put_norm(gp + "post_attention_norm.weight",
                     sd[hp + "post_attention_layernorm.weight"])
            put_norm(gp + "ffn_norm.weight",
                     sd[hp + "pre_feedforward_layernorm.weight"])
            put_norm(gp + "post_ffw_norm.weight",
                     sd[hp + "post_feedforward_layernorm.weight"])
        elif a == "olmo2":
            # post_attention_layernorm here is the attn-OUTPUT norm and
            # post_feedforward_layernorm the FFN-output norm
            # (llama-arch.cpp LLM_ARCH_OLMO2: ATTN_POST_NORM +
            # FFN_POST_NORM, no pre-norms)
            put_norm(gp + "post_attention_norm.weight",
                     sd[hp + "post_attention_layernorm.weight"])
            put_norm(gp + "post_ffw_norm.weight",
                     sd[hp + "post_feedforward_layernorm.weight"])
        else:
            put_norm(gp + "ffn_norm.weight",
                     sd[hp + "post_attention_layernorm.weight"])
        put(gp + "ffn_gate.weight", sd[hp + "mlp.gate_proj.weight"])
        put(gp + "ffn_up.weight", sd[hp + "mlp.up_proj.weight"])
        put(gp + "ffn_down.weight", sd[hp + "mlp.down_proj.weight"])
    put_norm("output_norm.weight", sd[f"{pfx}norm.weight"])
    if not tie and "lm_head.weight" in sd:
        put("output.weight", sd["lm_head.weight"])
    w.write()
    return Path(out_path)
