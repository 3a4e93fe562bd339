"""The port's adapters (``rrs_tpu_torch/models/adapter.py``: LoRA and control
vectors) against the JAX package's on the CPU: the LoRA delta over dense,
Q8_0 and TCQ4 bases through ``linear_apply``; ``load_lora_gguf``'s factors
and effective scale; ``attach_lora`` on the ``tiny`` preset, prefill logits
through ``InferenceContext``; a control vector in the forward, with the
per-layer hidden means the cvector tool collects; and ``load_model(fuse=False)``,
which LoRA needs, with the error ``attach_lora`` raises on fused weights.

The JAX side runs op by op (``jax.disable_jit``) where it runs a model, for
the reason tests/test_torch_model.py gives. Logits are held within that
file's LOGIT_ATOL."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.formats.tcq4 import quantize_tcq4
from rrs_tpu.models import adapter as jadapter
from rrs_tpu.models import linear as jlinear
from rrs_tpu.models import llama as jllama
from rrs_tpu.models.config import PRESETS as JAX_PRESETS
from rrs_tpu.runtime.context import InferenceContext as JaxContext
from rrs_tpu_torch.gguf.writer import GGUFWriter
from rrs_tpu_torch.models import adapter, llama
from rrs_tpu_torch.models.linear import DenseLinear, TCQ4Linear, linear_apply
from rrs_tpu_torch.models.loader import load_model
from rrs_tpu_torch.runtime.context import InferenceContext

from test_torch_common import linear_tree, rel_err, tcq4_gguf, torch_cfg, weights_tree

LOGIT_ATOL = 0.05
PROMPT = [3, 17, 42, 99, 5, 8, 250, 1, 77, 64, 12]


def _base(kind, w):
    if kind == "dense":
        return jlinear.DenseLinear(w=jnp.asarray(w.T, jnp.bfloat16))
    if kind == "q8":
        return jlinear.Q8Linear.quantize(w)
    return jlinear.TCQ4Linear.from_tensor(quantize_tcq4(w))


@pytest.mark.parametrize("kind,m,tol", [("dense", 3, 1e-4), ("q8", 3, 2e-2),
                                        ("tcq4", 1, 1e-5), ("tcq4", 20, 2e-2)])
def test_lora_delta_over_bases(kind, m, tol):
    """A LoRA-wrapped linear carried across by ``weights_from_numpy`` gives
    JAX's output; the delta is not zero. The TCQ4 prefill route rounds its
    operands to bf16 (tests/test_torch_tcq4.py holds it to 2e-2), and so
    does the port's Q8_0 route (tests/test_torch_q8_matmul.py)."""
    rng = np.random.default_rng(11)
    k, n, r = 512, 256, 8
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    a = (rng.standard_normal((k, r)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((r, n)) * 0.1).astype(np.float32)
    jl = jadapter.LoraLinear(base=_base(kind, w), a=jnp.asarray(a, jnp.bfloat16),
                             b=jnp.asarray(b, jnp.bfloat16), scale=1.5)
    tl = llama._linear_from_numpy(linear_tree(jl), "cpu")
    assert isinstance(tl, adapter.LoraLinear) and tl.a.dtype == torch.bfloat16
    x = rng.standard_normal((1, m, k)).astype(np.float32)
    ref = np.asarray(jlinear.linear_apply(jl, jnp.asarray(x)))
    got = linear_apply(tl, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, m, n)
    assert rel_err(got, ref) < tol
    base_only = linear_apply(tl.base, torch.from_numpy(x)).numpy()
    assert rel_err(base_only, got) > 10 * tol


def _write_adapter(path, cfg, rank, alpha, seed, targets):
    rng = np.random.default_rng(seed)
    w = GGUFWriter(path)
    w.add_string("general.architecture", cfg.arch)
    w.add_float32("adapter.lora.alpha", alpha)
    shapes = {"attn_q": (cfg.n_q_dim, cfg.n_embd), "attn_k": (cfg.n_kv_dim, cfg.n_embd),
              "attn_v": (cfg.n_kv_dim, cfg.n_embd), "attn_output": (cfg.n_embd, cfg.n_q_dim),
              "ffn_gate": (cfg.n_ff, cfg.n_embd), "ffn_up": (cfg.n_ff, cfg.n_embd),
              "ffn_down": (cfg.n_embd, cfg.n_ff)}
    for li in range(cfg.n_layers):
        for t in targets:
            n, k = shapes[t]
            w.add_tensor(f"blk.{li}.{t}.weight.lora_a",
                         (rng.standard_normal((rank, k)) * 0.3).astype(np.float32))
            w.add_tensor(f"blk.{li}.{t}.weight.lora_b",
                         (rng.standard_normal((n, rank)) * 0.3).astype(np.float32))
    return w.write()


def test_load_lora_gguf_matches_jax(tmp_path):
    cfg = JAX_PRESETS["tiny"]
    path = _write_adapter(tmp_path / "a.gguf", cfg, 4, 8.0, 1, ["attn_q", "ffn_down"])
    got, scale = adapter.load_lora_gguf(path, scale=0.5)
    ref, jscale = jadapter.load_lora_gguf(path, scale=0.5)
    assert scale == jscale == 0.5 and sorted(got) == sorted(ref) and len(got) == 4
    for name, (ja, jb, jeff) in ref.items():
        ta, tb, teff = got[name]
        assert teff == jeff == 0.5 * 8.0 / 4
        for t, j in ((ta, ja), (tb, jb)):
            assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
            np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


def _prefill(ctx, tokens):
    seq = ctx.new_sequence()
    out = ctx.prefill(seq, tokens)
    return np.asarray(out.float().numpy() if isinstance(out, torch.Tensor) else out, np.float32)


def test_attach_lora_prefill_matches_jax(tmp_path):
    cfg = JAX_PRESETS["tiny"]
    path = _write_adapter(tmp_path / "a.gguf", cfg, 4, 8.0, 2,
                          ["attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up",
                           "ffn_down"])
    jw = jllama.random_weights(cfg, seed=0)
    tw = llama.weights_from_numpy(torch_cfg(cfg), weights_tree(jw), device="cpu")
    with jax.disable_jit():
        base = _prefill(JaxContext(cfg, jw, n_lanes=1, max_seq=32), PROMPT)
    jadapter.attach_lora(jw, jadapter.load_lora_gguf(path)[0])
    adapter.attach_lora(tw, adapter.load_lora_gguf(path, device="cpu")[0])
    assert isinstance(tw.layers[1].w_down, adapter.LoraLinear)
    with jax.disable_jit():
        ref = _prefill(JaxContext(cfg, jw, n_lanes=1, max_seq=32), PROMPT)
    got = _prefill(InferenceContext(torch_cfg(cfg), tw, n_lanes=1, max_seq=32, device="cpu"),
                   PROMPT)
    assert got.shape == ref.shape == (len(PROMPT), cfg.vocab_size)
    np.testing.assert_allclose(got, ref, atol=LOGIT_ATOL, rtol=0)
    assert np.abs(ref - base).max() > 10 * LOGIT_ATOL


def test_control_vector_forward_matches_jax():
    cfg = JAX_PRESETS["tiny"]
    jw = jllama.random_weights(cfg, seed=3)
    tw = llama.weights_from_numpy(torch_cfg(cfg), weights_tree(jw), device="cpu")
    vecs = (np.random.default_rng(4).standard_normal((cfg.n_layers, cfg.n_embd)) * 0.5
            ).astype(np.float32)
    jcv = jadapter.ControlVector(vectors=jnp.asarray(vecs), strength=0.75)
    tcv = adapter.ControlVector(vectors=torch.from_numpy(vecs), strength=0.75)
    toks = np.asarray([PROMPT], np.int32)
    pos = np.arange(len(PROMPT), dtype=np.int32)[None]
    outs = {}
    for key, cv in (("base", None), ("cv", jcv)):
        ks, vs = jllama.scratch_caches(cfg, 1, 16)
        jcap = {"__hidden__": {}}
        with jax.disable_jit():
            logits, _, _ = jllama.forward(cfg, jw, jnp.asarray(toks), jnp.asarray(pos), ks, vs,
                                          jnp.asarray(pos), jnp.asarray(pos), cap=jcap,
                                          control_vector=cv)
        outs[key] = (np.asarray(logits), jcap["__hidden__"])
    tcfg = torch_cfg(cfg)
    ks, vs = llama.scratch_caches(tcfg, 1, 16)
    tcap = {"__hidden__": {}}
    got = llama.forward(tcfg, tw, toks, pos, ks, vs, pos, pos, cap=tcap,
                        control_vector=tcv).numpy()
    ref, jhidden = outs["cv"]
    np.testing.assert_allclose(got, ref, atol=LOGIT_ATOL, rtol=0)
    assert np.abs(ref - outs["base"][0]).max() > 10 * LOGIT_ATOL
    for li in range(cfg.n_layers):
        h = tcap["__hidden__"][li].numpy()
        assert h.dtype == np.float32 and h.shape == (cfg.n_embd,)
        assert np.linalg.norm(h - np.asarray(jhidden[li])) / np.linalg.norm(
            np.asarray(jhidden[li])) < 1e-2


def test_unfused_load_and_fused_refusal(tmp_path, monkeypatch):
    """Unfused TCQ4 linears keep their i8p packs (``RRS_PREFILL_I8`` on, as
    outside the test suite); the fused ones drop them, as in JAX."""
    monkeypatch.setenv("RRS_PREFILL_I8", "1")
    path = tcq4_gguf(tmp_path)
    cfg, w, _ = load_model(path, device="cpu", fuse=False)
    lw = w.layers[0]
    assert lw.wqkv is None and lw.w_gateup is None
    for lin in (lw.wq, lw.wk, lw.wv, lw.w_gate, lw.w_up):
        assert isinstance(lin, TCQ4Linear) and lin.i8p is not None
    _, fused, _ = load_model(path, device="cpu")
    assert fused.layers[0].wq is None and fused.layers[0].wqkv is not None
    assert fused.layers[0].wqkv.i8p is None and fused.layers[0].wo.i8p is not None
    jcfg = dataclasses.replace(JAX_PRESETS["tiny"], vocab_size=cfg.vocab_size)
    apath = _write_adapter(tmp_path / "a.gguf", jcfg, 4, 8.0, 5, ["attn_q"])
    adapters, _ = adapter.load_lora_gguf(apath)
    with pytest.raises(ValueError, match="fused"):
        adapter.attach_lora(fused, adapters)
    adapter.attach_lora(w, adapters)
    assert isinstance(w.layers[0].wq, adapter.LoraLinear)
    assert isinstance(w.layers[0].wk, TCQ4Linear)


def test_lora_on_the_loaded_model_equals_the_merged_file(tmp_path):
    """An F32 file with the adapter attached gives the logits of the file
    ``export-lora`` merged (the chip run's F16 check, on the CPU)."""
    from rrs_tpu_torch.models.export import export_random_gguf
    from rrs_tpu_torch.tools.export_lora import export_lora_merged

    cfg = torch_cfg(JAX_PRESETS["tiny"])
    base = export_random_gguf(cfg, tmp_path / "f32.gguf", seed=6)
    apath = _write_adapter(tmp_path / "a.gguf", JAX_PRESETS["tiny"], 4, 8.0, 7,
                           ["attn_q", "attn_v", "ffn_up", "ffn_down"])
    merged = export_lora_merged(base, apath, tmp_path / "merged.gguf")
    _, w, _ = load_model(base, device="cpu", fuse=False, dtype=torch.float32)
    adapter.attach_lora(w, adapter.load_lora_gguf(apath)[0])
    _, wm, _ = load_model(merged, device="cpu", dtype=torch.float32)
    got = _prefill(InferenceContext(cfg, w, n_lanes=1, max_seq=32, device="cpu"), PROMPT)
    ref = _prefill(InferenceContext(cfg, wm, n_lanes=1, max_seq=32, device="cpu"), PROMPT)
    np.testing.assert_allclose(got, ref, atol=LOGIT_ATOL, rtol=0)
    assert isinstance(w.layers[0].wo, DenseLinear)
