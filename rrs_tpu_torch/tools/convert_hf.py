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
phi3 and the qwen2vl text stack. ``convert_hf_mmproj`` (``convert-hf
--mmproj``) extracts a VLM's vision tower into an mmproj GGUF with clip.cpp's
tensor and key names: Qwen2-VL / Qwen2.5-VL (the conv3d stem split into its
two temporal slices, the fused qkv split, the merger), Pixtral, Idefics3 and
InternVL, the same bytes as the JAX package's.

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


def convert_hf_mmproj(model_dir: str | Path, out_path: str | Path,
                      out_dtype=np.float32) -> Path:
    """Extract the vision tower of a VLM checkpoint into an mmproj GGUF
    (the reference's --mmproj converter mode; clip-impl.h tensor/KV names).
    Supports Qwen2-VL (PROJECTOR_TYPE_QWEN2VL: conv3d stem split into two
    temporal slices, fused qkv split, merger MLP)."""
    model_dir = Path(model_dir)
    cfg = json.loads((model_dir / "config.json").read_text())
    arch_name = (cfg.get("architectures") or ["?"])[0]
    vc_type = (cfg.get("vision_config") or {}).get("model_type")
    if vc_type == "pixtral":
        return _convert_mmproj_pixtral(model_dir, cfg, out_path, out_dtype)
    if arch_name == "Idefics3ForConditionalGeneration":
        return _convert_mmproj_idefics3(model_dir, cfg, out_path, out_dtype)
    if arch_name == "InternVLForConditionalGeneration":
        return _convert_mmproj_internvl(model_dir, cfg, out_path, out_dtype)
    is25 = (arch_name == "Qwen2_5_VLForConditionalGeneration"
            or cfg.get("model_type") == "qwen2_5_vl"
            or vc_type == "qwen2_5_vl")
    if not is25 and arch_name != "Qwen2VLForConditionalGeneration" \
            and cfg.get("model_type") != "qwen2_vl":
        raise ValueError(f"mmproj extraction not supported for {arch_name}")
    vc = cfg["vision_config"]
    e = int(vc.get("embed_dim", vc.get("hidden_size")))
    depth = int(vc.get("depth", 32))
    heads = int(vc.get("num_heads", 16))
    n_ff = int(vc.get("intermediate_size", e * int(vc.get("mlp_ratio", 4))))
    # 2.5 renames: vision dim = hidden_size, LLM dim = out_hidden_size
    out_dim = int(vc.get("out_hidden_size",
                         vc.get("hidden_size", cfg.get("hidden_size"))))
    patch = int(vc.get("patch_size", 14))
    merge = int(vc.get("spatial_merge_size", 2))
    tpatch = int(vc.get("temporal_patch_size", 2))

    sd = _load_state_dict(model_dir)
    vp = "visual." if any(k.startswith("visual.") for k in sd) \
        else "model.visual."

    w = GGUFWriter(out_path)
    w.add_string("general.architecture", "clip")
    w.add_string("clip.projector_type",
                 "qwen2.5vl_merger" if is25 else "qwen2vl_merger")
    w.add_bool("clip.has_vision_encoder", True)
    if is25:
        # HF fullatt_block_indexes [7,15,23,31] <-> the reference's
        # periodic n_wa_pattern (clip.cpp KEY_WIN_ATTN_PATTERN): full
        # attention every (idx0+1) layers
        fab = vc.get("fullatt_block_indexes") or [7]
        w.add_uint32("clip.vision.n_wa_pattern", int(fab[0]) + 1)
        w.add_uint32("clip.vision.attn_window_size",
                     int(vc.get("window_size", 112)))
    w.add_uint32("clip.vision.patch_size", patch)
    w.add_uint32("clip.vision.image_size", patch * merge)  # dynamic-res min
    w.add_uint32("clip.vision.embedding_length", e)
    w.add_uint32("clip.vision.block_count", depth)
    w.add_uint32("clip.vision.attention.head_count", heads)
    w.add_uint32("clip.vision.feed_forward_length", n_ff)
    w.add_uint32("clip.vision.projection_dim", out_dim)
    w.add_uint32("clip.vision.spatial_merge_size", merge)
    w.add_float32("clip.vision.attention.layer_norm_epsilon", 1e-6)

    def put(name, arr):
        w.add_tensor(name, np.ascontiguousarray(
            np.asarray(arr).astype(out_dtype)))

    # conv3d stem [E, 3, tpatch, p, p] -> two temporal slices, matching the
    # reference's v.patch_embd.weight / .weight.1 split
    pw = sd[vp + "patch_embed.proj.weight"].reshape(e, 3, tpatch, patch,
                                                    patch)
    put("v.patch_embd.weight", pw[:, :, 0])
    put("v.patch_embd.weight.1", pw[:, :, 1])
    for i in range(depth):
        hp = f"{vp}blocks.{i}."
        gp = f"v.blk.{i}."
        put(gp + "ln1.weight", sd[hp + "norm1.weight"])
        if hp + "norm1.bias" in sd:               # 2.5: RMS, no bias
            put(gp + "ln1.bias", sd[hp + "norm1.bias"])
        qkv_w = sd[hp + "attn.qkv.weight"]        # [3E, E] fused
        qkv_b = sd[hp + "attn.qkv.bias"]
        for j, nm in enumerate(("q", "k", "v")):
            put(gp + f"attn_{nm}.weight", qkv_w[j * e:(j + 1) * e])
            put(gp + f"attn_{nm}.bias", qkv_b[j * e:(j + 1) * e])
        put(gp + "attn_out.weight", sd[hp + "attn.proj.weight"])
        put(gp + "attn_out.bias", sd[hp + "attn.proj.bias"])
        put(gp + "ln2.weight", sd[hp + "norm2.weight"])
        if hp + "norm2.bias" in sd:
            put(gp + "ln2.bias", sd[hp + "norm2.bias"])
        if is25:                                  # silu-gated MLP
            put(gp + "ffn_gate.weight", sd[hp + "mlp.gate_proj.weight"])
            put(gp + "ffn_gate.bias", sd[hp + "mlp.gate_proj.bias"])
            put(gp + "ffn_up.weight", sd[hp + "mlp.up_proj.weight"])
            put(gp + "ffn_up.bias", sd[hp + "mlp.up_proj.bias"])
            put(gp + "ffn_down.weight", sd[hp + "mlp.down_proj.weight"])
            put(gp + "ffn_down.bias", sd[hp + "mlp.down_proj.bias"])
        else:
            put(gp + "ffn_up.weight", sd[hp + "mlp.fc1.weight"])
            put(gp + "ffn_up.bias", sd[hp + "mlp.fc1.bias"])
            put(gp + "ffn_down.weight", sd[hp + "mlp.fc2.weight"])
            put(gp + "ffn_down.bias", sd[hp + "mlp.fc2.bias"])
    # merger: ln_q -> post_ln, mlp.{0,2} -> mm.{0,2}
    put("v.post_ln.weight", sd[vp + "merger.ln_q.weight"])
    if vp + "merger.ln_q.bias" in sd:
        put("v.post_ln.bias", sd[vp + "merger.ln_q.bias"])
    put("mm.0.weight", sd[vp + "merger.mlp.0.weight"])
    put("mm.0.bias", sd[vp + "merger.mlp.0.bias"])
    put("mm.2.weight", sd[vp + "merger.mlp.2.weight"])
    put("mm.2.bias", sd[vp + "merger.mlp.2.bias"])
    w.write()
    return Path(out_path)


def _convert_mmproj_pixtral(model_dir: Path, cfg: dict, out_path, out_dtype):
    """Pixtral vision tower -> mmproj GGUF (clip-impl.h
    PROJECTOR_TYPE_PIXTRAL tensor names: RMSNorm ln1/ln2 without biases,
    silu-gated ffn_gate, mm.1/mm.2 projector, learned
    v.token_embd.img_break row from the LLM embedding table)."""
    vc = cfg["vision_config"]
    e = int(vc.get("hidden_size", 1024))
    depth = int(vc.get("num_hidden_layers", 24))
    heads = int(vc.get("num_attention_heads", 16))
    n_ff = int(vc.get("intermediate_size", 4 * e))
    patch = int(vc.get("patch_size", 16))
    theta = float(vc.get("rope_theta", 10000.0))
    out_dim = int((cfg.get("text_config") or {}).get("hidden_size",
                                                     cfg.get("hidden_size",
                                                             e)))

    sd = _load_state_dict(model_dir)
    vt = "vision_tower." if any(k.startswith("vision_tower.") for k in sd) \
        else "model.vision_tower."
    mp = "multi_modal_projector." \
        if any(k.startswith("multi_modal_projector.") for k in sd) \
        else "model.multi_modal_projector."

    w = GGUFWriter(out_path)
    w.add_string("general.architecture", "clip")
    w.add_string("clip.projector_type", "pixtral")
    w.add_bool("clip.has_vision_encoder", True)
    w.add_uint32("clip.vision.patch_size", patch)
    w.add_uint32("clip.vision.image_size", int(vc.get("image_size", 1024)))
    w.add_uint32("clip.vision.embedding_length", e)
    w.add_uint32("clip.vision.block_count", depth)
    w.add_uint32("clip.vision.attention.head_count", heads)
    w.add_uint32("clip.vision.feed_forward_length", n_ff)
    w.add_uint32("clip.vision.projection_dim", out_dim)
    w.add_uint32("clip.vision.spatial_merge_size", 1)
    w.add_float32("clip.vision.attention.layer_norm_epsilon", 1e-5)
    w.add_float32("clip.vision.rope.freq_base", theta)

    def put(name, arr):
        w.add_tensor(name, np.ascontiguousarray(
            np.asarray(arr).astype(out_dtype)))

    put("v.patch_embd.weight", sd[vt + "patch_conv.weight"])
    put("v.pre_ln.weight", sd[vt + "ln_pre.weight"])
    for i in range(depth):
        hp = f"{vt}transformer.layers.{i}."
        gp = f"v.blk.{i}."
        put(gp + "ln1.weight", sd[hp + "attention_norm.weight"])
        put(gp + "ln2.weight", sd[hp + "ffn_norm.weight"])
        for nm, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj")):
            put(gp + f"attn_{nm}.weight",
                sd[hp + f"attention.{hf}.weight"])
        put(gp + "attn_out.weight", sd[hp + "attention.o_proj.weight"])
        put(gp + "ffn_gate.weight",
            sd[hp + "feed_forward.gate_proj.weight"])
        put(gp + "ffn_up.weight", sd[hp + "feed_forward.up_proj.weight"])
        put(gp + "ffn_down.weight",
            sd[hp + "feed_forward.down_proj.weight"])
    put("mm.1.weight", sd[mp + "linear_1.weight"])
    if mp + "linear_1.bias" in sd:
        put("mm.1.bias", sd[mp + "linear_1.bias"])
    put("mm.2.weight", sd[mp + "linear_2.weight"])
    if mp + "linear_2.bias" in sd:
        put("mm.2.bias", sd[mp + "linear_2.bias"])
    # the [IMG_BREAK] embedding row from the language model's table
    brk = cfg.get("image_break_token_id")
    emb_key = next((k for k in ("model.language_model.embed_tokens.weight",
                                "language_model.model.embed_tokens.weight",
                                "model.embed_tokens.weight")
                    if k in sd), None)
    if brk is not None and emb_key is not None:
        put("v.token_embd.img_break", sd[emb_key][int(brk)])
    w.write()
    return Path(out_path)


def _mmproj_writer(out_path, proj_type, *, image_size, patch, e, depth,
                   heads, n_ff, out_dim, eps=1e-6, extra=None):
    w = GGUFWriter(out_path)
    w.add_string("general.architecture", "clip")
    w.add_string("clip.projector_type", proj_type)
    w.add_bool("clip.has_vision_encoder", True)
    w.add_uint32("clip.vision.image_size", image_size)
    w.add_uint32("clip.vision.patch_size", patch)
    w.add_uint32("clip.vision.embedding_length", e)
    w.add_uint32("clip.vision.block_count", depth)
    w.add_uint32("clip.vision.attention.head_count", heads)
    w.add_uint32("clip.vision.feed_forward_length", n_ff)
    w.add_uint32("clip.vision.projection_dim", out_dim)
    w.add_float32("clip.vision.attention.layer_norm_epsilon", eps)
    for k, v in (extra or {}).items():
        if isinstance(v, bool):
            w.add_bool(k, v)
        elif isinstance(v, int):
            w.add_uint32(k, v)
        elif isinstance(v, float):
            w.add_float32(k, v)
        else:
            w.add_string(k, v)
    return w


def _convert_mmproj_idefics3(model_dir: Path, cfg: dict, out_path,
                             out_dtype):
    """Idefics3/SmolVLM vision tower -> mmproj GGUF (clip-impl.h:217
    PROJECTOR_TYPE_IDEFICS3: SigLIP-shaped ViT + pixel shuffle +
    mm.model.fc projection)."""
    vc = cfg["vision_config"]
    e = int(vc["hidden_size"])
    depth = int(vc["num_hidden_layers"])
    sd = _load_state_dict(model_dir)
    vp = "model.vision_model."
    out_dim = int(cfg.get("text_config", {}).get("hidden_size", 2048))
    w = _mmproj_writer(
        out_path, "idefics3", image_size=int(vc["image_size"]),
        patch=int(vc["patch_size"]), e=e, depth=depth,
        heads=int(vc["num_attention_heads"]),
        n_ff=int(vc["intermediate_size"]), out_dim=out_dim,
        extra={"clip.vision.projector.scale_factor":
               int(cfg.get("scale_factor", 2))})

    def put(name, arr):
        w.add_tensor(name, np.ascontiguousarray(
            np.asarray(arr).astype(out_dtype)))

    put("v.patch_embd.weight", sd[vp + "embeddings.patch_embedding.weight"])
    put("v.patch_embd.bias", sd[vp + "embeddings.patch_embedding.bias"])
    put("v.position_embd.weight",
        sd[vp + "embeddings.position_embedding.weight"])
    for i in range(depth):
        hp = f"{vp}encoder.layers.{i}."
        gp = f"v.blk.{i}."
        for a, b in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
            put(gp + f"{a}.weight", sd[hp + b + ".weight"])
            put(gp + f"{a}.bias", sd[hp + b + ".bias"])
        for a, b in (("attn_q", "self_attn.q_proj"),
                     ("attn_k", "self_attn.k_proj"),
                     ("attn_v", "self_attn.v_proj"),
                     ("attn_out", "self_attn.out_proj"),
                     ("ffn_up", "mlp.fc1"), ("ffn_down", "mlp.fc2")):
            put(gp + f"{a}.weight", sd[hp + b + ".weight"])
            put(gp + f"{a}.bias", sd[hp + b + ".bias"])
    put("v.post_ln.weight", sd[vp + "post_layernorm.weight"])
    put("v.post_ln.bias", sd[vp + "post_layernorm.bias"])
    put("mm.model.fc.weight",
        sd["model.connector.modality_projection.proj.weight"])
    w.write()
    return Path(out_path)


def _convert_mmproj_internvl(model_dir: Path, cfg: dict, out_path,
                             out_dtype):
    """InternVL vision tower -> mmproj GGUF (clip-impl.h:221
    PROJECTOR_TYPE_INTERNVL: CLS token, per-layer ls1/ls2 scales, pixel
    shuffle, mm.model.mlp.{0,1,3} projector)."""
    vc = cfg["vision_config"]
    e = int(vc["hidden_size"])
    depth = int(vc["num_hidden_layers"])
    sd = _load_state_dict(model_dir)
    vp = "model.vision_tower." if any(
        k.startswith("model.vision_tower.") for k in sd) else "vision_tower."
    out_dim = int(cfg.get("text_config", {}).get("hidden_size", 2048))
    ds = float(cfg.get("downsample_ratio", 0.5))
    def _sq(v):      # InternVL stores [h, w] lists for these
        return int(v[0] if isinstance(v, (list, tuple)) else v)

    w = _mmproj_writer(
        out_path, "internvl", image_size=_sq(vc["image_size"]),
        patch=_sq(vc["patch_size"]), e=e, depth=depth,
        heads=int(vc["num_attention_heads"]),
        n_ff=int(vc["intermediate_size"]), out_dim=out_dim,
        eps=float(vc.get("layer_norm_eps", 1e-6)),
        extra={"clip.vision.projector.scale_factor": int(round(1.0 / ds))})

    def put(name, arr):
        w.add_tensor(name, np.ascontiguousarray(
            np.asarray(arr).astype(out_dtype)))

    put("v.patch_embd.weight",
        sd[vp + "embeddings.patch_embeddings.projection.weight"])
    put("v.patch_embd.bias",
        sd[vp + "embeddings.patch_embeddings.projection.bias"])
    put("v.class_embd", sd[vp + "embeddings.cls_token"].reshape(-1))
    put("v.position_embd.weight",
        sd[vp + "embeddings.position_embeddings"].reshape(-1, e))
    for i in range(depth):
        hp = f"{vp}encoder.layer.{i}."
        gp = f"v.blk.{i}."
        put(gp + "ls1.weight", sd[hp + "lambda_1"])
        put(gp + "ls2.weight", sd[hp + "lambda_2"])
        for a, b in (("ln1", "layernorm_before"), ("ln2", "layernorm_after")):
            put(gp + f"{a}.weight", sd[hp + b + ".weight"])
            put(gp + f"{a}.bias", sd[hp + b + ".bias"])
        for a, b in (("attn_q", "attention.q_proj"),
                     ("attn_k", "attention.k_proj"),
                     ("attn_v", "attention.v_proj"),
                     ("attn_out", "attention.projection_layer"),
                     ("ffn_up", "mlp.fc1"), ("ffn_down", "mlp.fc2")):
            put(gp + f"{a}.weight", sd[hp + b + ".weight"])
            if hp + b + ".bias" in sd:
                put(gp + f"{a}.bias", sd[hp + b + ".bias"])
    mp = "model.multi_modal_projector." if any(
        k.startswith("model.multi_modal_projector.") for k in sd) \
        else "multi_modal_projector."
    put("mm.model.mlp.0.weight", sd[mp + "layer_norm.weight"])
    put("mm.model.mlp.0.bias", sd[mp + "layer_norm.bias"])
    put("mm.model.mlp.1.weight", sd[mp + "linear_1.weight"])
    put("mm.model.mlp.1.bias", sd[mp + "linear_1.bias"])
    put("mm.model.mlp.3.weight", sd[mp + "linear_2.weight"])
    put("mm.model.mlp.3.bias", sd[mp + "linear_2.bias"])
    w.write()
    return Path(out_path)
