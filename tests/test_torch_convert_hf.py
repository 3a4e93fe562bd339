"""The port's HF -> GGUF converter (``rrs_tpu_torch/tools/convert_hf.py``)
and its safetensors reader (``tools/safetensors_io.py``) against the JAX
package's converter and the ``safetensors`` package, on the CPU.

For each architecture of tests/test_convert_hf.py (and granite and olmo2,
whose branches permute q / k and move the norms), a tiny ``transformers``
model is saved to a temporary directory and both converters write the same
bytes from it. A BF16 checkpoint, the dtype Qwen3, Llama and Gemma publish
in, makes the JAX converter raise in a process of its own (its
``safe_open(framework="np")`` holds bfloat16 only once ``ml_dtypes`` is
imported), while the port's file from it equals JAX's file from the same
weights saved as F32: BF16 decodes to f32 exactly."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from rrs_tpu.tools.convert_hf import convert_hf_to_gguf as jax_convert  # noqa: E402
from rrs_tpu_torch.tools import safetensors_io  # noqa: E402
from rrs_tpu_torch.tools.convert_hf import convert_hf_to_gguf  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
ARCHS = {
    "llama": ("LlamaConfig", "LlamaForCausalLM",
              dict(SMALL, rms_norm_eps=1e-6, tie_word_embeddings=False)),
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM", dict(SMALL, head_dim=16,
                                                      tie_word_embeddings=True)),
    "mamba": ("MambaConfig", "MambaForCausalLM",
              dict(vocab_size=128, hidden_size=64, state_size=8, num_hidden_layers=2,
                   conv_kernel=4, expand=2, time_step_rank=4, use_cache=False,
                   tie_word_embeddings=True)),
    "gemma2": ("Gemma2Config", "Gemma2ForCausalLM",
               dict(SMALL, num_hidden_layers=4, head_dim=16, query_pre_attn_scalar=16,
                    sliding_window=8, attn_logit_softcapping=50.0,
                    final_logit_softcapping=30.0, tie_word_embeddings=True)),
    "deepseek2-dense": ("DeepseekV2Config", "DeepseekV2ForCausalLM",
                        dict(SMALL, num_key_value_heads=4, q_lora_rank=None, kv_lora_rank=32,
                             qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=24,
                             head_dim=16, first_k_dense_replace=2, n_routed_experts=4,
                             n_shared_experts=1, num_experts_per_tok=2,
                             moe_intermediate_size=48, topk_method="greedy", n_group=None,
                             topk_group=None, tie_word_embeddings=False)),
    "deepseek2-moe": ("DeepseekV2Config", "DeepseekV2ForCausalLM",
                      dict(SMALL, num_hidden_layers=3, num_key_value_heads=4, q_lora_rank=24,
                           kv_lora_rank=32, qk_rope_head_dim=16, qk_nope_head_dim=32,
                           v_head_dim=24, head_dim=16, first_k_dense_replace=1,
                           n_routed_experts=8, n_shared_experts=2, num_experts_per_tok=2,
                           moe_intermediate_size=48, topk_method="greedy", n_group=None,
                           topk_group=None, norm_topk_prob=False, routed_scaling_factor=1.0,
                           tie_word_embeddings=False)),
    "gpt-oss": ("GptOssConfig", "GptOssForCausalLM",
                dict(SMALL, intermediate_size=64, head_dim=16, num_local_experts=4,
                     num_experts_per_tok=2, sliding_window=4, rope_scaling=None,
                     tie_word_embeddings=False)),
    "phi3": ("Phi3Config", "Phi3ForCausalLM",
             dict(SMALL, pad_token_id=0, bos_token_id=1, eos_token_id=2,
                  tie_word_embeddings=False, sliding_window=None)),
    "granite": ("GraniteConfig", "GraniteForCausalLM",
                dict(SMALL, embedding_multiplier=6.0, residual_multiplier=0.22,
                     logits_scaling=4.0, attention_multiplier=0.015625)),
    "olmo2": ("Olmo2Config", "Olmo2ForCausalLM", dict(SMALL, tie_word_embeddings=False)),
}


def _save(directory, name, dtype=None):
    conf_cls, model_cls, kw = ARCHS[name]
    if not hasattr(transformers, model_cls):
        pytest.skip(f"transformers lacks {model_cls}")
    config = getattr(transformers, conf_cls)(**kw)
    torch.manual_seed(0)
    model = getattr(transformers, model_cls)(config).eval()
    if dtype is not None:
        model = model.to(dtype)
    model.save_pretrained(str(directory), safe_serialization=True)
    config.save_pretrained(str(directory))
    return directory


@pytest.mark.parametrize("name", sorted(ARCHS))
@pytest.mark.parametrize("outtype", ["f32", "f16"])
def test_convert_matches_jax(tmp_path, name, outtype):
    d = _save(tmp_path / "hf", name)
    dt = np.float16 if outtype == "f16" else np.float32
    jax_convert(d, tmp_path / "j.gguf", out_dtype=dt)
    out = convert_hf_to_gguf(d, tmp_path / "t.gguf", out_dtype=dt)
    assert out.read_bytes() == (tmp_path / "j.gguf").read_bytes()


def test_tokenizer_export_matches_jax(tmp_path):
    """tests/test_convert_hf.py's BPE tokenizer.json case, weights written
    by the port's safetensors writer."""
    d = tmp_path / "hf"
    d.mkdir()
    (d / "tokenizer.json").write_text(json.dumps({
        "model": {"type": "BPE", "vocab": {"a": 0, "b": 1, "ab": 2, "<eos>": 3},
                  "merges": ["a b"]},
        "added_tokens": [{"id": 3, "content": "<eos>"}]}))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "eos_token": "<eos>", "chat_template": "x{{messages}}"}))
    (d / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "num_hidden_layers": 0, "hidden_size": 8,
        "intermediate_size": 16, "num_attention_heads": 2, "vocab_size": 4}))
    safetensors_io.save_safetensors(d / "model.safetensors", {
        "model.embed_tokens.weight": np.zeros((4, 8), np.float32),
        "model.norm.weight": np.ones((8,), np.float32)})
    jax_convert(d, tmp_path / "j.gguf")
    out = convert_hf_to_gguf(d, tmp_path / "t.gguf")
    assert out.read_bytes() == (tmp_path / "j.gguf").read_bytes()
    from rrs_tpu_torch.gguf.reader import read_gguf

    with read_gguf(out) as g:
        assert list(g.metadata["tokenizer.ggml.tokens"]) == ["a", "b", "ab", "<eos>"]
        assert g.metadata["tokenizer.ggml.eos_token_id"] == 3


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int64])
def test_safetensors_io_against_the_package(tmp_path, dtype):
    st = pytest.importorskip("safetensors.numpy")
    rng = np.random.default_rng(3)
    tensors = {"a.weight": (rng.standard_normal((5, 7)) * 3).astype(dtype),
               "b": (rng.standard_normal((3,)) * 100).astype(dtype),
               "scalar": np.asarray(rng.standard_normal() * 10).astype(dtype),
               "empty": np.zeros((0, 4), dtype)}
    st.save_file(tensors, str(tmp_path / "pkg.safetensors"))
    got = safetensors_io.load_safetensors(tmp_path / "pkg.safetensors")
    safetensors_io.save_safetensors(tmp_path / "port.safetensors", tensors,
                                    metadata={"format": "pt"})
    back = st.load_file(str(tmp_path / "port.safetensors"))
    for name, ref in tensors.items():
        for arr in (got[name], back[name]):
            assert arr.dtype == ref.dtype and arr.shape == ref.shape
            np.testing.assert_array_equal(arr, ref)


JAX_BF16 = """
import sys
from rrs_tpu.tools.convert_hf import convert_hf_to_gguf
assert "ml_dtypes" not in sys.modules
try:
    convert_hf_to_gguf(sys.argv[1], sys.argv[2])
except TypeError as e:
    print("TypeError:", e)
"""


def test_bf16_checkpoint(tmp_path):
    """JAX's converter reads a BF16 checkpoint only in a process where
    ``ml_dtypes`` (which jax imports) has taught NumPy bfloat16; alone, as a
    process of its own, it raises. The port's converter, which needs neither,
    writes from it the file JAX writes from the same weights in F32."""
    bf = _save(tmp_path / "bf16" / "hf", "qwen3", torch.bfloat16)
    f32 = _save(tmp_path / "f32" / "hf", "qwen3", torch.bfloat16)
    model = transformers.Qwen3ForCausalLM.from_pretrained(str(f32), dtype=torch.float32)
    model.save_pretrained(str(f32), safe_serialization=True)
    header, _ = safetensors_io.read_header(next(bf.glob("*.safetensors")))
    assert {v["dtype"] for k, v in header.items() if k != "__metadata__"} == {"BF16"}
    r = subprocess.run([sys.executable, "-c", JAX_BF16, str(bf), str(tmp_path / "x.gguf")],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "TypeError: data type 'bfloat16' not understood" in r.stdout, r.stdout
    jax_convert(f32, tmp_path / "j.gguf")
    out = convert_hf_to_gguf(bf, tmp_path / "t.gguf")
    assert out.read_bytes() == (tmp_path / "j.gguf").read_bytes()
    # torch's own bf16 -> f32 on the same tensors
    sd = safetensors_io.load_safetensors(next(bf.glob("*.safetensors")))
    ref = model.state_dict()["model.layers.0.self_attn.q_proj.weight"].numpy()
    np.testing.assert_array_equal(sd["model.layers.0.self_attn.q_proj.weight"], ref)


def test_bin_checkpoint(tmp_path):
    """``pytorch_model.bin`` goes through ``torch.load(weights_only=True)``."""
    d = _save(tmp_path / "hf", "llama")
    sd = safetensors_io.load_safetensors(next(d.glob("*.safetensors")))
    for f in d.glob("*.safetensors"):
        f.unlink()
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               d / "pytorch_model.bin")
    jax_convert(d, tmp_path / "j.gguf")
    out = convert_hf_to_gguf(d, tmp_path / "t.gguf")
    assert out.read_bytes() == (tmp_path / "j.gguf").read_bytes()


def test_mmproj_refused(tmp_path, capsys):
    """``convert-hf --mmproj``, which raised naming ROADMAP A11, extracts the
    vision tower: from a tiny Qwen2-VL checkpoint the verb writes JAX's
    mmproj file byte for byte, F32 and F16 (every branch is held in
    tests/test_torch_mtmd_projectors.py)."""
    from rrs_tpu.tools.convert_hf import convert_hf_mmproj as jax_mmproj
    from rrs_tpu_torch.__main__ import main

    from test_torch_qwen2vl import tiny_qwen2vl

    d = tiny_qwen2vl(tmp_path / "hf")
    for outtype, dt in (("f32", np.float32), ("f16", np.float16)):
        main(["convert-hf", str(d), str(tmp_path / f"t-{outtype}.gguf"), "--mmproj",
              "--outtype", outtype])
        assert f"wrote {tmp_path / f't-{outtype}.gguf'}" in capsys.readouterr().out
        jax_mmproj(d, tmp_path / f"j-{outtype}.gguf", out_dtype=dt)
        assert (tmp_path / f"t-{outtype}.gguf").read_bytes() == \
            (tmp_path / f"j-{outtype}.gguf").read_bytes()
