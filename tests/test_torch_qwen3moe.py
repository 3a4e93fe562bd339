"""qwen3moe through rrs_tpu_torch against rrs_tpu: ``ModelConfig.from_gguf`` on
the Qwen3-30B-A3B metadata, the TCQ4_K32 dequantizer of a quantized router,
the random and carried-over MoE weights, and a tiny qwen3moe GGUF (2 layers,
E = 256, 8 experts of 256 top-2) written by the JAX package's exporter, loaded
as it is (dense f32 expert stacks) and after the JAX quantizer turned every
expert stack and the router into TCQ4_K32. Both packages load it; greedy
``generate`` gives the same tokens over prompts that take the rows kernel
(B9), the capacity dispatch (B10) and the overflow scan; the port serves it on
the CPU.

The exporter writes no ``qwen3moe.norm_topk_prob`` key and the JAX config
reads the post-top-k norm from it, as the port does: both loaders get it
through ``overrides``, where the published config sets it. The JAX package
loads through its NumPy tile decode and runs op by op (``jax.disable_jit``),
for the reasons given in tests/test_torch_context.py."""

import dataclasses
import http.client
import json
import threading
from http.server import ThreadingHTTPServer
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu import native as jax_native
from rrs_tpu.formats import kquants as jax_kquants
from rrs_tpu.gguf.constants import GGMLType
from rrs_tpu.models import llama as jax_llama
from rrs_tpu.models import loader as jax_loader
from rrs_tpu.models.config import ModelConfig as JaxConfig
from rrs_tpu.models.export import export_random_gguf
from rrs_tpu.models.moe import quantize_experts as jax_quantize_experts
from rrs_tpu.quantize.quantizer import quantize_model
from rrs_tpu.runtime.context import InferenceContext as JaxContext
from rrs_tpu_torch.formats import kquants
from rrs_tpu_torch.models import llama
from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.models.loader import load_model
from rrs_tpu_torch.runtime.context import InferenceContext

from test_torch_common import linear_tree, tiny_vocab_tokens, torch_cfg, weights_tree

NORM = {"qwen3moe.norm_topk_prob": True}
TINY = JaxConfig(arch="qwen3moe", n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, head_dim=64,
                 n_ff=512, vocab_size=256, context_length=1024, rope_theta=1e6, qk_norm=True,
                 n_experts=8, n_experts_used=2, n_ff_exp=256, norm_topk_prob=True)
MOE_FIELDS = ("router", "gate", "up", "down", "gate_qs", "gate_eff", "up_qs", "up_eff",
              "down_qs", "down_eff")


def _bits(x) -> np.ndarray:
    """Array or tensor -> NumPy, bf16 as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _assert_moe_equal(tm, jm):
    for f in MOE_FIELDS:
        t, j = getattr(tm, f), getattr(jm, f)
        assert (t is None) == (j is None), f
        if t is not None:
            np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=f)


def qwen3_30b_a3b_metadata(**extra) -> dict:
    """GGUF metadata of Qwen3-30B-A3B as its published config.json gives it
    (and as llama.cpp's converter writes it), without the tokenizer."""
    a = "qwen3moe"
    md = {"general.architecture": a, f"{a}.block_count": 48, f"{a}.context_length": 40960,
          f"{a}.embedding_length": 2048, f"{a}.feed_forward_length": 6144,
          f"{a}.attention.head_count": 32, f"{a}.attention.head_count_kv": 4,
          f"{a}.attention.key_length": 128, f"{a}.attention.value_length": 128,
          f"{a}.attention.layer_norm_rms_epsilon": 1e-6, f"{a}.rope.freq_base": 1e6,
          f"{a}.expert_count": 128, f"{a}.expert_used_count": 8,
          f"{a}.expert_feed_forward_length": 768, f"{a}.vocab_size": 151936,
          f"{a}.norm_topk_prob": True}
    md.update(extra)
    return md


@pytest.mark.parametrize("extra", [{}, {"qwen3moe.norm_topk_prob": False},
                                   {"qwen3moe.attention.sliding_window": 4096}],
                         ids=["published", "no norm_topk_prob", "sliding window"])
def test_from_gguf_matches_jax(extra):
    md = qwen3_30b_a3b_metadata(**extra)
    cfg = ModelConfig.from_gguf(md)
    assert cfg == torch_cfg(JaxConfig.from_gguf(md))
    assert cfg.qk_norm and not cfg.attn_bias and cfg.expert_gating_softmax
    assert (cfg.n_experts, cfg.n_experts_used, cfg.n_ff_exp, cfg.n_q_dim) == (128, 8, 768, 4096)
    assert cfg.norm_topk_prob == md["qwen3moe.norm_topk_prob"]
    assert cfg.is_swa(5) == ("qwen3moe.attention.sliding_window" in md)


def test_qwen2moe_and_dense_moe_raise():
    """A llama file with MoE layers (Mixtral-style) reads as JAX reads it: an
    MoE layer in a dense architecture, which raised here, is ported (its
    forward is held in tests/test_torch_families.py). A mamba file, which
    raised here naming ROADMAP A9b, reads as JAX reads it (its forward is
    held in tests/test_torch_recurrent.py); the multimodal qwen2vl, which
    raised here naming ROADMAP A11, reads as JAX reads it, with its M-RoPE
    sections. (qwen2moe, which raised here, is ported: its
    config is checked in tests/test_torch_qwen2moe.py.)"""
    from rrs_tpu.models.config import ModelConfig as JaxConfig

    md = {"general.architecture": "llama", "llama.block_count": 2,
          "llama.embedding_length": 64, "llama.expert_count": 8}
    cfg = ModelConfig.from_gguf(md)
    assert cfg == torch_cfg(JaxConfig.from_gguf(md)) and cfg.n_experts == 8
    md = {"general.architecture": "mamba", "mamba.block_count": 2, "mamba.embedding_length": 64}
    cfg = ModelConfig.from_gguf(md)
    assert cfg == torch_cfg(JaxConfig.from_gguf(md)) and cfg.is_recurrent
    md = {"general.architecture": "qwen2vl", "qwen2vl.block_count": 2,
          "qwen2vl.embedding_length": 64, "qwen2vl.rope.dimension_sections": [2, 3, 3, 0]}
    cfg = ModelConfig.from_gguf(md)
    assert cfg == torch_cfg(JaxConfig.from_gguf(md)) and cfg.rope_sections == (2, 3, 3, 0)


@pytest.mark.parametrize("shape", [(16, 512), (3, 24, 256)], ids=["router", "expert stack"])
def test_tcq4_dequantize_matches_jax(shape):
    """The original-domain TCQ4_K32 decode (inverse FWHT) of a 2-D weight and
    of a stack of per-expert payloads."""
    from rrs_tpu.formats.tcq4 import quantize_tcq4
    from rrs_tpu.formats.tile_codec import encode_tcq4_gguf

    rng = np.random.default_rng(len(shape))
    w = rng.standard_normal(shape).astype(np.float32)
    mats = w.reshape(-1, *shape[-2:])
    raw = np.frombuffer(b"".join(bytes(encode_tcq4_gguf(quantize_tcq4(m))) for m in mats),
                        np.uint8)
    ref = jax_kquants.dequantize(raw, GGMLType.TCQ4_K32, shape)
    got = kquants.dequantize(raw, GGMLType.TCQ4_K32, shape)
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert np.abs(got - w).max() < 0.5 * np.abs(w).max()      # it is the weight, not its rotation


def test_random_weights_draw_moe_as_jax():
    """An MoE layer draws its router and dense stacks before its linears, in
    the order of the JAX ``random_weights``, so both packages build the
    same model."""
    cfg = dataclasses.replace(TINY, n_layers=2)
    jw = jax_llama.random_weights(cfg, seed=3, quantize=True)
    tw = llama.random_weights(torch_cfg(cfg), seed=3, quantize=True)
    for jl, tl in zip(jw.layers, tw.layers):
        assert tl.w_gate is tl.w_up is tl.w_down is None
        _assert_moe_equal(tl.moe, jl.moe)
        np.testing.assert_array_equal(tl.wq.qs.numpy(), np.asarray(jl.wq.qs))
        np.testing.assert_array_equal(tl.wo.qs.numpy(), np.asarray(jl.wo.qs))
    np.testing.assert_array_equal(_bits(tw.embed), _bits(jw.embed))


@pytest.mark.parametrize("stacks", ["dense", "tcq4"])
def test_weights_from_numpy_carries_moe(stacks):
    """The JAX MoE layers cross over bit for bit, and the 2-layer model's
    prefill logits agree (30 tokens: the capacity dispatch)."""
    jw = jax_llama.random_weights(TINY, seed=4, quantize=True)
    if stacks == "tcq4":
        for lw in jw.layers:
            lw.moe = jax_quantize_experts(lw.moe)
    tw = llama.weights_from_numpy(torch_cfg(TINY), weights_tree(jw), device="cpu")
    for jl, tl in zip(jw.layers, tw.layers):
        assert tl.moe.quant_kind == "tcq4" and tl.moe.quantized == (stacks == "tcq4")
        _assert_moe_equal(tl.moe, jl.moe)
    prompt = [int(t) for t in np.random.default_rng(4).integers(0, 256, 30)]
    with jax.disable_jit():
        jctx = JaxContext(TINY, jw, n_lanes=1, max_seq=64)
        ref = np.asarray(jctx.prefill(jctx.new_sequence(), prompt)[-1], np.float32)
    tctx = InferenceContext(torch_cfg(TINY), tw, n_lanes=1, max_seq=64, device="cpu")
    got = tctx.prefill(tctx.new_sequence(), prompt)[-1].float().numpy()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-2
    assert int(got.argmax()) == int(ref.argmax())


# -- the tiny qwen3moe GGUF ------------------------------------------------------

@pytest.fixture(scope="module")
def moe_ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_qwen3moe")
    src, dst = d / "f32.gguf", d / "tcq4.gguf"
    export_random_gguf(TINY, src, seed=0, vocab_tokens=tiny_vocab_tokens(256))
    quantize_model(src, dst, verbose=False)
    return {"dense": src, "tcq4": dst}


def jax_load(path):
    with mock.patch.object(jax_native, "available", lambda: False):
        return jax_loader.load_model(path, overrides=NORM)


@pytest.mark.parametrize("stacks", ["dense", "tcq4"])
def test_gguf_loads_equal_in_both_packages(moe_ggufs, stacks):
    from rrs_tpu_torch.gguf.reader import read_gguf

    jcfg, jw, _ = jax_load(moe_ggufs[stacks])
    cfg, w, _ = load_model(moe_ggufs[stacks], device="cpu", overrides=NORM)
    assert cfg == torch_cfg(jcfg) and cfg.norm_topk_prob and cfg.qk_norm
    for jl, tl in zip(jw.layers, w.layers):
        assert tl.moe.quant_kind == "tcq4" and tl.moe.quantized == (stacks == "tcq4")
        _assert_moe_equal(tl.moe, jl.moe)
        assert tl.w_gate is tl.w_up is tl.w_down is tl.w_gateup is None
    with read_gguf(moe_ggufs[stacks]) as g:
        kinds = {GGMLType(g.tensors[n].ggml_type).name
                 for n in ("blk.0.ffn_gate_inp.weight", "blk.0.ffn_down_exps.weight")}
    assert kinds == ({"TCQ4_K32"} if stacks == "tcq4" else {"F32"})


# prompt -> the MoE branch its prefill takes (bucket 16: rows; bucket 64:
# capacity, which always covers it; 300 copies of a token plus the bucket's
# 212 padding rows overflow the capacity of 256 and take the scan). W4A4 sits
# on a knife edge: the two packages' attention outputs differ in their last
# bf16 bit, the int4 activation quantizer turns that into flipped codes, and
# of seven 40-token prompts (seeds 1-7) one (seed 1) changes its first token
# (ROADMAP queue C); the prompts here are free of such a tie.
PROMPTS = {"rows": list(range(40, 52)),
           "capacity": [int(t) for t in np.random.default_rng(2).integers(0, 256, 40)],
           "overflow": [77] * 300}


@pytest.mark.parametrize("prompt", sorted(PROMPTS))
@pytest.mark.parametrize("stacks", ["dense", "tcq4"])
def test_generate_tokens_match_jax(moe_ggufs, stacks, prompt):
    """Greedy prefill + 4 decode steps (the rows branch) of both packages."""
    jcfg, jw, _ = jax_load(moe_ggufs[stacks])
    with jax.disable_jit():
        ref = JaxContext(jcfg, jw, n_lanes=1, max_seq=512 + 16).generate(PROMPTS[prompt], 4)
    cfg, w, _ = load_model(moe_ggufs[stacks], device="cpu", overrides=NORM)
    ctx = InferenceContext(cfg, w, n_lanes=1, max_seq=512 + 16, device="cpu")
    got = ctx.generate(PROMPTS[prompt], 4)
    assert len(got) == 4 and got == ref


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request(method, path, json.dumps(body) if body is not None else None,
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data


def test_server_answers_qwen3moe_on_cpu(moe_ggufs):
    """The engine over the TCQ4 qwen3moe model on the CPU with two lanes: two
    concurrent completions (one prefill step for both, then batched decode
    steps) and a chat completion finish with their token counts."""
    from rrs_tpu_torch.models.vocab import Vocab
    from rrs_tpu_torch.serving.engine import Engine
    from rrs_tpu_torch.serving.server import ServerState, make_handler

    cfg, w, md = load_model(moe_ggufs["tcq4"], device="cpu", overrides=NORM)
    ctx = InferenceContext(cfg, w, n_lanes=2, max_seq=128, device="cpu")
    engine = Engine(ctx)
    state = ServerState(cfg, Vocab.from_gguf(md), engine, md, "tiny-qwen3moe")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    engine.start()
    results = {}

    def complete(i, prompt):
        results[i] = _http(port, "POST", "/v1/completions",
                           {"prompt": prompt, "max_tokens": 5, "temperature": 0.0})
    try:
        threads = [threading.Thread(target=complete, args=(i, p))
                   for i, p in enumerate(("abcdefghij" * 3, "klmnop"))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        for status, data in results.values():
            out = json.loads(data)
            assert status == 200 and out["usage"]["completion_tokens"] == 5
            assert out["choices"][0]["finish_reason"] == "length"
        status, data = _http(port, "POST", "/v1/chat/completions",
                             {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4})
        assert status == 200, data
        assert json.loads(data)["choices"][0]["finish_reason"] in ("length", "stop")
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
