"""The dense families of the layer body through rrs_tpu_torch against rrs_tpu:
gemma2, gemma3, granite, minicpm, olmo2, phi3 and a llama-architecture file
whose layers are MoE (Mixtral-style).

Each family's file is written by JAX's exporter at a small size (2 layers,
E = 256, 4 / 2 heads x 64, FF 512, a 256-token vocabulary; gemma3 6 layers,
so that its pattern of 6 has a global layer), with its norms drawn around 1
and the family's own tensors and keys added by rewriting the file with JAX's
writer:

* gemma2: sliding pattern 2 with a window of 8, sandwich norms, GEGLU, the
  sqrt(E) embedding scale, and softcaps of 1 on the scores and 2 on the
  logits (the published 50 / 30 barely bite on random weights);
* gemma3: pattern 6, window 8, q / k norms, linear x8 RoPE scaling on the
  global layer and a 10k base on the sliding ones;
* granite: the embedding, residual, attention and logit scales of
  tests/test_model.py's HF check;
* minicpm: its default scales;
* olmo2: no pre-norms, post-attention / post-FFN norms, q / k norms over the
  whole projection;
* phi3: pre-fused ``attn_qkv`` and gate|up in ``ffn_up``, partial rotary (32
  of 64 dims) and LongRoPE factors (trained context 512 over an original 128,
  so the long factors and the attention scale sqrt(1 + ln 4 / ln 128));
* llama-moe: 8 experts of 256, top-2.

Held: the config field by field, 40-token prefill logits (rel L2 within
``GLUE_TOL``, and elementwise within tests/test_swa.py's 2e-2 of the largest
logit), greedy tokens
identical on these dense weights (up to a step where JAX's own top two
logits tie at bf16 resolution: phi3's fourth token), ``apply_rope`` with linear scaling,
partial rotary and frequency factors, ``quantize`` byte-equal to JAX's on
the sandwich-norm and pre-fused-qkv files, and ``ctx.embed``, which follows
the forward's layer body where JAX's ``hidden`` skips the embedding and
residual scales and the sandwich / post norms (ROADMAP queue C). The JAX
package loads through its NumPy route and runs op by op
(``jax.disable_jit``), as in tests/test_torch_qwen2moe.py.
"""

import dataclasses
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu import native as jax_native
from rrs_tpu.models import loader as jax_loader
from rrs_tpu.models.config import ModelConfig as JaxConfig
from rrs_tpu.models.export import export_random_gguf
from rrs_tpu.ops import basic as jax_basic
from rrs_tpu.runtime.context import InferenceContext as JaxContext
from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.models.loader import load_model
from rrs_tpu_torch.ops import basic
from rrs_tpu_torch.runtime.context import InferenceContext

from test_torch_common import assert_same_greedy, rewrite_gguf, torch_cfg

GLUE_TOL = 0.05
BASE = dict(n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, head_dim=64, n_ff=512,
            vocab_size=256, context_length=512)
# family -> (the exporter's config fields, extra GGUF keys)
FAMILIES = {
    "gemma2": (dict(arch="gemma2", swa_window=8, sandwich_norm=True, tie_embeddings=True),
               {"gemma2.attn_logit_softcapping": 1.0, "gemma2.final_logit_softcapping": 2.0}),
    "gemma3": (dict(arch="gemma3", n_layers=6, swa_window=8, sandwich_norm=True, qk_norm=True,
                    tie_embeddings=True),
               {"gemma3.rope.scaling.type": "linear", "gemma3.rope.scaling.factor": 8.0,
                "gemma3.rope.freq_base": 1e6}),
    "granite": (dict(arch="granite"),
                {"granite.embedding_scale": 6.0, "granite.residual_scale": 0.22,
                 "granite.logit_scale": 4.0, "granite.attention.scale": 0.015625}),
    "minicpm": (dict(arch="minicpm"), {}),
    "olmo2": (dict(arch="olmo2", qk_norm=True), {}),
    "phi3": (dict(arch="phi3"),
             {"phi3.rope.dimension_count": 32, "phi3.rope.scaling.factor": 4.0,
              "phi3.rope.scaling.original_context_length": 128}),
    "llama-moe": (dict(arch="llama", n_experts=8, n_experts_used=2, n_ff_exp=256), {}),
}
NAMES = list(FAMILIES)
PROMPT = [int(t) for t in np.random.default_rng(3).integers(0, 256, 40)]


def _edit(family: str):
    """The tensor edit of a family's rewrite: norms drawn around 1, then
    olmo2's and phi3's own tensors."""
    rng = np.random.default_rng(11)
    held: dict = {}
    q_dim, kv_dim, e = BASE["n_heads"] * 64, BASE["n_kv_heads"] * 64, BASE["n_embd"]

    def norm(n):
        return (1.0 + 0.3 * rng.standard_normal(n)).astype(np.float32)

    def edit(name, arr):
        if name == "":
            if family == "phi3":
                return {"rope_factors_long.weight": rng.uniform(1.0, 4.0, 16).astype(np.float32),
                        "rope_factors_short.weight": rng.uniform(1.0, 2.0, 16).astype(np.float32)}
            return {}
        if family == "olmo2":
            if name.endswith(("attn_norm.weight", "ffn_norm.weight")):
                return {}
            if name.endswith("attn_q_norm.weight"):
                return {name: norm(q_dim)}
            if name.endswith("attn_k_norm.weight"):
                p = name.rsplit(".", 2)[0]
                return {name: norm(kv_dim), f"{p}.post_attention_norm.weight": norm(e),
                        f"{p}.post_ffw_norm.weight": norm(e)}
        if family == "phi3":
            p, kind = name.rsplit(".", 2)[0], name.rsplit(".", 2)[1]
            if kind in ("attn_q", "attn_k", "ffn_gate"):
                held[name] = arr
                return {}
            if kind == "attn_v":
                return {f"{p}.attn_qkv.weight": np.concatenate(
                    [held[f"{p}.attn_q.weight"], held[f"{p}.attn_k.weight"], arr])}
            if kind == "ffn_up":
                return {name: np.concatenate([held[f"{p}.ffn_gate.weight"], arr])}
        if name.endswith("norm.weight"):
            return {name: norm(arr.shape[0])}
        return {name: arr}

    return edit


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_families")
    out = {}
    for fam, (fields, keys) in FAMILIES.items():
        cfg = JaxConfig(**{**BASE, **fields})
        src = d / f"{fam}-export.gguf"
        export_random_gguf(cfg, src, seed=NAMES.index(fam))
        out[fam] = rewrite_gguf(src, d / f"{fam}.gguf", kv=keys, edit=_edit(fam))
    return out


def jax_load(path):
    with mock.patch.object(jax_native, "available", lambda: False):
        return jax_loader.load_model(path)


@pytest.mark.parametrize("family", NAMES)
def test_config_matches_jax(files, family):
    from rrs_tpu.gguf.reader import read_gguf as jax_read_gguf

    g = jax_read_gguf(files[family])
    md = dict(g.metadata)
    g.close()
    cfg = ModelConfig.from_gguf(md)
    assert cfg == torch_cfg(JaxConfig.from_gguf(md))
    expect = {
        "gemma2": dict(swa_pattern=2, swa_window=8, attn_softcap=1.0, final_softcap=2.0,
                       ffn_act="gelu", embd_scale=16.0, sandwich_norm=True, attn_scale=0.125),
        "gemma3": dict(swa_pattern=6, rope_theta_swa=10000.0, rope_scaling_type="linear",
                       rope_scale_factor=8.0, qk_norm=True, sandwich_norm=True, ffn_act="gelu"),
        "granite": dict(embd_scale=6.0, residual_scale=0.22, logits_divisor=4.0,
                        attn_scale=0.015625, rope_neox=False),
        "minicpm": dict(embd_scale=12.0, residual_scale=1.4 / math.sqrt(2), logits_divisor=1.0),
        "olmo2": dict(qk_norm=True, qk_norm_full=True, post_norm_only=True),
        "phi3": dict(rope_rot_dim=32, rope_orig_context=128, rope_scale_factor=4.0),
        "llama-moe": dict(n_experts=8, n_experts_used=2, n_ff_exp=256, rope_neox=False),
    }[family]
    for k, v in expect.items():
        assert getattr(cfg, k) == pytest.approx(v), k


@pytest.mark.parametrize("family", NAMES)
def test_logits_and_greedy_tokens_match_jax(files, family):
    jcfg, jw, _ = jax_load(files[family])
    with jax.disable_jit():
        ref_toks = JaxContext(jcfg, jw, n_lanes=1, max_seq=64).generate(PROMPT, 4)
        jctx = JaxContext(jcfg, jw, n_lanes=1, max_seq=64)
        forced = np.asarray(jctx.prefill(jctx.new_sequence(), PROMPT + ref_toks[:3]),
                            np.float32)
    ref = forced[:len(PROMPT)]
    cfg, w, _ = load_model(files[family], device="cpu")
    assert cfg == torch_cfg(jcfg)
    if family == "phi3":
        assert w.layers[0].wqkv is not None and w.layers[0].w_gateup is not None
        np.testing.assert_array_equal(w.rope_factors.numpy(), np.asarray(jw.rope_factors))
    if family in ("gemma2", "gemma3", "olmo2"):
        assert all(lw.attn_post_norm is not None and lw.ffn_post_norm is not None
                   for lw in w.layers)
    ctx = InferenceContext(cfg, w, n_lanes=1, max_seq=64, device="cpu")
    got = ctx.prefill(ctx.new_sequence(), PROMPT).float().numpy()
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < GLUE_TOL, rel
    # tests/test_swa.py's 2e-2, taken relative to the largest logit: the
    # logits leave the head in bf16, whose step at |x| >= 4 is 0.03
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()
    toks = InferenceContext(cfg, w, n_lanes=1, max_seq=64, device="cpu").generate(PROMPT, 4)
    assert_same_greedy(toks, ref_toks, forced[len(PROMPT) - 1:])


ROPE_CASES = {
    "linear x8": (dict(scaling_type="linear", scale_factor=8.0), None),
    "partial neox": (dict(rot_dim=32), None),
    "partial interleaved": (dict(rot_dim=32, neox=False), None),
    "freq factors": (dict(rot_dim=32, scale_factor=4.0, orig_context=128), "factors"),
    "yarn x40, attn_factor": (dict(scaling_type="yarn", scale_factor=40.0, orig_context=4096,
                                   neox=False, attn_factor=1.0 / (1.0 + 0.1 * math.log(40.0))),
                              None),
}


@pytest.mark.parametrize("case", list(ROPE_CASES))
def test_apply_rope_matches_jax(case):
    kw, ff = ROPE_CASES[case]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 5)).astype(np.int32)
    factors = rng.uniform(1.0, 4.0, 16).astype(np.float32) if ff else None
    ref = jax_basic.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                               jax_basic.RopeParams(head_dim=64, theta=1e4, **kw),
                               freq_factors=None if ff is None else jnp.asarray(factors))
    got = basic.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           basic.RopeParams(head_dim=64, theta=1e4, **kw),
                           freq_factors=None if ff is None else torch.from_numpy(factors))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    if "attn_factor" in kw:
        # MLA's factor cancels YaRN's cos / sin scale: lengths are kept
        np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1),
                                   np.linalg.norm(x, axis=-1), rtol=1e-5)


@pytest.mark.parametrize("family", ["gemma2", "phi3"])
def test_quantize_is_byte_equal_to_jax(files, family, tmp_path):
    """The sandwich-norm and pre-fused-qkv files through ``quantize``."""
    from rrs_tpu.quantize.quantizer import quantize_model as jax_quantize
    from rrs_tpu_torch.quantize.quantizer import quantize_model

    jax_quantize(files[family], tmp_path / "jax.gguf", verbose=False)
    quantize_model(files[family], tmp_path / "torch.gguf", verbose=False)
    assert (tmp_path / "torch.gguf").read_bytes() == (tmp_path / "jax.gguf").read_bytes()


def _jax_forward_hidden(jcfg, jw, toks) -> np.ndarray:
    """The final-normed hidden states of JAX's own forward, mean-pooled: the
    forward with an identity head and no logit scaling."""
    from rrs_tpu.models import llama as jllama
    from rrs_tpu.models.linear import DenseLinear as JaxDense

    e = jcfg.n_embd
    w = dataclasses.replace(jw, lm_head=JaxDense(w=jnp.eye(e, dtype=jnp.bfloat16)))
    c = dataclasses.replace(jcfg, logits_divisor=1.0, final_softcap=0.0)
    t = len(toks)
    ks, vs = jllama.scratch_caches(c, 1, t)
    pos = jnp.arange(t, dtype=jnp.int32)[None, :]
    hid, _, _ = jllama.forward(c, w, jnp.asarray([toks], jnp.int32), pos, ks, vs, pos, pos)
    return np.asarray(hid[0], np.float32).mean(0)


@pytest.mark.parametrize("family", ["granite", "gemma3", "olmo2"])
def test_embed_follows_the_forward_where_jax_hidden_does_not(files, family):
    """``ctx.embed`` pools the forward's own final hidden states (JAX's,
    through an identity head); JAX's ``embed`` runs a layer body without the
    embedding / residual scales and the sandwich / post norms, and parts
    from them (a JAX fault the port does not copy, ROADMAP queue C)."""
    toks = PROMPT[:12]
    jcfg, jw, _ = jax_load(files[family])
    with jax.disable_jit():
        want = _jax_forward_hidden(jcfg, jw, toks)
        jax_embed = np.asarray(JaxContext(jcfg, jw, n_lanes=1, max_seq=64).embed(toks),
                               np.float32)
    cfg, w, _ = load_model(files[family], device="cpu")
    got = InferenceContext(cfg, w, n_lanes=1, max_seq=64, device="cpu").embed(toks)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    jax_rel = np.linalg.norm(jax_embed - want) / np.linalg.norm(want)
    assert rel < 1e-2, rel
    assert jax_rel > 0.1, jax_rel
