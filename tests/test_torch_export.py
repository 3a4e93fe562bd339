"""The port's exporter (``rrs_tpu_torch/models/export.py``) against the JAX
package's: ``export_random_gguf`` writes the same bytes from the same seed
for every branch (MoE, gpt-oss with MXFP4 experts, MLA with a q LoRA and
the lite form, sliding-window, sandwich norms, recurrent, a vocabulary with
scores and token types), and ``export_weights_gguf`` writes the same bytes
from the same unfused dense weights."""

import dataclasses

import numpy as np
import pytest
import torch

from rrs_tpu.gguf.constants import GGMLType as JaxGGMLType
from rrs_tpu.models import loader as jax_loader
from rrs_tpu.models.config import PRESETS as JAX_PRESETS
from rrs_tpu.models.config import ModelConfig as JaxConfig
from rrs_tpu.models.export import export_random_gguf as jax_export
from rrs_tpu.models.export import export_weights_gguf as jax_export_weights
from rrs_tpu_torch.gguf.constants import GGMLType
from rrs_tpu_torch.models.export import export_random_gguf, export_weights_gguf
from rrs_tpu_torch.models.loader import load_model

from test_torch_common import jax_cfg, tiny_vocab_tokens, torch_cfg

MAMBA = dict(arch="mamba", n_layers=2, n_embd=128, n_heads=0, n_kv_heads=0, head_dim=0,
             n_ff=0, vocab_size=256, context_length=512, ssm_d_conv=4, ssm_d_inner=256,
             ssm_d_state=16, ssm_dt_rank=8)
CASES = {
    "qwen3moe": lambda: jax_cfg(arch="qwen3moe", n_experts=4, n_experts_used=2, n_ff_exp=256),
    "gpt-oss-mxfp4": lambda: JAX_PRESETS["tiny-oss"],
    "mla": lambda: JAX_PRESETS["tiny-mla"],
    "mla-lite-v3": lambda: dataclasses.replace(JAX_PRESETS["tiny-mla"], q_lora_rank=0,
                                               expert_gating_softmax=False,
                                               n_expert_groups=2, n_group_used=1),
    "swa-sandwich": lambda: jax_cfg(arch="gemma3", swa_window=32, swa_pattern=2,
                                    sandwich_norm=True, tie_embeddings=True),
    "mamba": lambda: JaxConfig(**MAMBA),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_export_random_gguf_every_branch(tmp_path, name):
    cfg = CASES[name]()
    kw = {}
    if name == "gpt-oss-mxfp4":
        kw = dict(expert_ggml_type=JaxGGMLType.MXFP4)
    jpath, tpath = tmp_path / "j.gguf", tmp_path / "t.gguf"
    jax_export(cfg, jpath, seed=3, vocab_tokens=tiny_vocab_tokens(cfg.vocab_size), **kw)
    if kw:
        kw = dict(expert_ggml_type=GGMLType.MXFP4)
    out = export_random_gguf(torch_cfg(cfg), tpath, seed=3,
                             vocab_tokens=tiny_vocab_tokens(cfg.vocab_size), **kw)
    assert out == tpath
    assert tpath.read_bytes() == jpath.read_bytes()


def test_export_random_gguf_scores_and_types(tmp_path):
    cfg = jax_cfg(vocab_size=64)
    toks = tiny_vocab_tokens(64)
    scores = list(np.random.default_rng(0).standard_normal(64))
    types = [1] * 60 + [3, 3, 6, 6]
    for fn, c, p in ((jax_export, cfg, tmp_path / "j.gguf"),
                     (export_random_gguf, torch_cfg(cfg), tmp_path / "t.gguf")):
        fn(c, p, seed=1, dtype=np.float16, vocab_tokens=toks, vocab_model="t5",
           vocab_scores=scores, vocab_types=types)
    assert (tmp_path / "t.gguf").read_bytes() == (tmp_path / "j.gguf").read_bytes()


@pytest.mark.parametrize("over", [{}, {"attn_bias": True, "tie_embeddings": False}])
def test_export_weights_gguf_matches_jax(tmp_path, over):
    cfg = jax_cfg(**over)
    src = tmp_path / "src.gguf"
    jax_export(cfg, src, seed=5, vocab_tokens=tiny_vocab_tokens(cfg.vocab_size))
    jcfg, jw, jmd = jax_loader.load_model(src, dtype=np.float32, fuse=False)
    tcfg, tw, tmd = load_model(src, dtype=torch.float32, device="cpu", fuse=False)
    jax_export_weights(jcfg, jw, tmp_path / "j.gguf", metadata=jmd)
    out = export_weights_gguf(tcfg, tw, tmp_path / "t.gguf", metadata=tmd)
    assert out.read_bytes() == (tmp_path / "j.gguf").read_bytes()


def test_export_weights_gguf_refuses_quantized(tmp_path):
    """A fused or quantized layer cannot be written back, as in JAX."""
    from test_torch_common import tcq4_gguf

    path = tcq4_gguf(tmp_path)
    cfg, w, _ = load_model(path, device="cpu", fuse=False)
    with pytest.raises(ValueError, match="only dense layers"):
        export_weights_gguf(cfg, w, tmp_path / "x.gguf")
