"""rrs_tpu_torch/parallel/pipeline.py and ``compute_perplexity_pp`` against
the JAX package's: the GPipe schedule over pp stages of the conftest's
virtual CPU devices (JAX) and of CPU stages (the port), on the same GGUF,
and ``perplexity --pp 2 --device cpu`` through the port's CLI."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.models.config import ModelConfig as JaxConfig
from rrs_tpu.models.export import export_random_gguf
from rrs_tpu.models.loader import load_model as jax_load_model
from rrs_tpu.parallel.pipeline import make_pp_mesh as jax_pp_mesh
from rrs_tpu.parallel.pipeline import pipeline_forward as jax_pipeline_forward
from rrs_tpu_torch.models.loader import load_model
from rrs_tpu_torch.parallel.pipeline import make_pipeline_forward, make_pp_mesh

from test_torch_common import exact_jit, tiny_vocab_tokens


def _both(path, pp, n_micro, tokens, positions):
    jcfg, jw, _ = jax_load_model(path, dtype=np.float32, fuse=False)
    with exact_jit():
        want = np.asarray(jax_pipeline_forward(jcfg, jw, jnp.asarray(tokens),
                                               jnp.asarray(positions), jax_pp_mesh(pp),
                                               n_micro=n_micro))
    cfg, w, _ = load_model(path, dtype=torch.float32, device="cpu", fuse=False)
    b, t = tokens.shape
    got = make_pipeline_forward(cfg, w, make_pp_mesh(devices=["cpu"] * pp), b, t,
                                n_micro=n_micro)(tokens, positions).numpy()
    return cfg, w, got, want


@pytest.mark.parametrize("pp,n_micro", [(4, 2), (2, 4)])
def test_pipeline_matches_jax(tmp_path, pp, n_micro):
    from rrs_tpu_torch.models import llama

    cfg0 = JaxConfig(arch="qwen3", n_layers=4, n_embd=64, n_heads=4, n_kv_heads=2, head_dim=16,
                     n_ff=128, vocab_size=64, context_length=64, qk_norm=True)
    export_random_gguf(cfg0, tmp_path / "m.gguf", seed=9)
    b, t = 4, 8
    tokens = np.random.default_rng(0).integers(0, 64, (b, t)).astype(np.int32)
    positions = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    cfg, w, got, want = _both(tmp_path / "m.gguf", pp, n_micro, tokens, positions)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    # and the port's single-device forward over the same chunk
    ks, vs = llama.scratch_caches(cfg, b, t)
    with torch.inference_mode():
        one = llama.forward(cfg, w, torch.from_numpy(tokens), torch.from_numpy(positions), ks, vs,
                            torch.from_numpy(positions), torch.from_numpy(positions))
    np.testing.assert_allclose(got, one.numpy(), rtol=2e-3, atol=2e-3)


def test_pipeline_moe_matches_jax(tmp_path):
    cfg0 = JaxConfig(arch="qwen3moe", n_layers=2, n_embd=64, n_heads=4, n_kv_heads=2, head_dim=16,
                     n_ff=0, vocab_size=64, context_length=64, qk_norm=True, n_experts=4,
                     n_experts_used=2, n_ff_exp=64, norm_topk_prob=True)
    export_random_gguf(cfg0, tmp_path / "m.gguf", seed=11)
    tokens = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    positions = np.broadcast_to(np.arange(4, dtype=np.int32), (2, 4)).copy()
    _, _, got, want = _both(tmp_path / "m.gguf", 2, 2, tokens, positions)
    assert got.shape == (2, 4, 64) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def _form(form: str):
    """(cfg, weights, the same model without the form's feature) for a layer
    form that the JAX package's ``_one_layer`` does not model."""
    import dataclasses

    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.config import PRESETS, ModelConfig

    base = dict(n_layers=4, n_embd=64, n_heads=4, n_kv_heads=2, head_dim=16, n_ff=128,
                vocab_size=64, context_length=64)
    if form == "mla":
        cfg = dataclasses.replace(PRESETS["tiny-mla"], n_layers=2, n_dense_lead=2)
        w = llama.fabricated_mla_weights(cfg, seed=3, device="cpu", quantized=False)
        return cfg, w, None
    if form == "residual_scale":
        cfg = ModelConfig(arch="granite", residual_scale=0.22, embd_scale=6.0,
                          logits_divisor=4.0, attn_scale=0.015625, **base)
        w = llama.random_weights(cfg, seed=3, dtype=torch.float32, scale=0.2)
        return cfg, w, (dataclasses.replace(cfg, residual_scale=1.0), w)
    cfg = ModelConfig(arch="llama", **base)
    w = llama.random_weights(cfg, seed=3, dtype=torch.float32, scale=0.2)
    w_long = dataclasses.replace(w, rope_factors=torch.linspace(1.0, 4.0, 8))
    return cfg, w_long, (cfg, w)


@pytest.mark.parametrize("form", ["residual_scale", "rope_factors", "mla"])
def test_pipeline_runs_every_layer_form(form):
    """Each stage runs the single-device forward's block, so granite's
    residual_scale, LongRoPE factors and MLA give ``llama.forward``'s logits
    (the JAX package's ``_one_layer`` drops them: ROADMAP queue C); the
    model without the form's feature gives other logits, so the check
    sees it."""
    from rrs_tpu_torch.models import llama

    cfg, w, neutral = _form(form)
    b, t = 2, 8
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, t)).astype(np.int64)
    positions = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()

    def single(c, wt):
        ks, vs = llama.scratch_caches(c, b, t)
        pos = torch.from_numpy(positions)
        with torch.inference_mode():
            return llama.forward(c, wt, torch.from_numpy(tokens), pos, ks, vs, pos,
                                 pos).float().numpy()

    got = make_pipeline_forward(cfg, w, make_pp_mesh(devices=["cpu"] * 2), b, t,
                                n_micro=2)(tokens, positions).numpy()
    want = single(cfg, w)
    assert got.shape == (b, t, cfg.vocab_size) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    if neutral is not None:
        assert np.abs(single(*neutral) - want).max() > 100 * 2e-3
    else:   # MLA: the plain attention over its latent cache is what ran
        assert cfg.is_mla and w.layers[0].wkv_a is not None


def test_pipeline_refuses_sandwich_norms_and_uneven_stages(tmp_path):
    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.models import llama

    cfg = ModelConfig(arch="gemma2", n_layers=2, n_embd=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, n_ff=128, vocab_size=64, context_length=64,
                      sandwich_norm=True)
    w = llama.random_weights(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="sandwich-norm"):
        make_pipeline_forward(cfg, w, make_pp_mesh(devices=["cpu"] * 2), 2, 4)
    cfg3 = ModelConfig(arch="qwen3", n_layers=3, n_embd=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, n_ff=128, vocab_size=64, context_length=64)
    with pytest.raises(ValueError, match="3 layers do not split into pp=2"):
        make_pipeline_forward(cfg3, llama.random_weights(cfg3, device="cpu"),
                              make_pp_mesh(devices=["cpu"] * 2), 2, 4)


def test_perplexity_pp_matches_jax(tmp_path, capsys):
    """``compute_perplexity_pp`` over 2 stages equals JAX's, and equals the
    single-device ``compute_perplexity`` within JAX's 2%; ``perplexity --pp
    2 --device cpu`` prints the same PPL."""
    from rrs_tpu.parallel.pipeline import make_pp_mesh as jmesh
    from rrs_tpu.tools.perplexity import compute_perplexity_pp as jax_ppl_pp
    from rrs_tpu_torch.__main__ import main
    from rrs_tpu_torch.runtime.context import InferenceContext
    from rrs_tpu_torch.tools.perplexity import compute_perplexity, compute_perplexity_pp

    cfg0 = JaxConfig(arch="qwen3", n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2,
                     head_dim=64, n_ff=512, vocab_size=256, context_length=512, qk_norm=True)
    path = tmp_path / "m.gguf"
    vocab = tiny_vocab_tokens(256)
    export_random_gguf(cfg0, path, seed=0, vocab_tokens=vocab)
    tokens = np.random.default_rng(5).integers(0, 256, 3 * 48).tolist()
    jcfg, jw, _ = jax_load_model(path)
    with exact_jit():
        want = jax_ppl_pp(jcfg, jw, tokens, jmesh(2), n_ctx=48, n_micro=2)
    cfg, w, _ = load_model(path, device="cpu")
    got = compute_perplexity_pp(cfg, w, tokens, make_pp_mesh(devices=["cpu"] * 2), n_ctx=48,
                                n_micro=2)
    assert got.n_tokens == want.n_tokens == 3 * 23
    # log-perplexities within 1e-2 (tests/test_torch_perplexity.py allows 0.1)
    np.testing.assert_allclose(np.log([got.ppl] + got.per_chunk),
                               np.log([want.ppl] + want.per_chunk), rtol=0, atol=1e-2)
    base = compute_perplexity(InferenceContext(cfg, w, n_lanes=1, max_seq=64, device="cpu"),
                              tokens, n_ctx=48)
    assert abs(got.ppl - base.ppl) / base.ppl < 0.02, (got.ppl, base.ppl)

    text = tmp_path / "t.txt"
    text.write_text("".join(vocab[t] for t in tokens), encoding="utf-8")
    main(["perplexity", "-m", str(path), "-f", str(text), "--n-ctx", "48", "--pp", "2",
          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "(pp=2)" in out and f"over {got.n_tokens} tokens" in out
