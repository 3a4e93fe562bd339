"""gpt-oss through rrs_tpu_torch against rrs_tpu: YaRN RoPE, the ring
(sliding-window) K/V store, a tiny MXFP4 gpt-oss GGUF written by the JAX
package's exporter (``tiny-oss``: 3 layers, sliding layers 0 and 2 with a
window of 8, sinks, biases, 4 experts top-2) loaded by both packages, its
prefill and decode logits against the JAX context run op by op
(``jax.disable_jit``, as tests/test_torch_context.py runs it) with identical
greedy tokens, and the server answering a gpt-oss request on the CPU.

Both GGUF loads override the RoPE scaling to YaRN (factor 4 over an original
context of 64), which the exporter does not write, so that the model path
runs it. The logits are f32 sums over bf16 activations taken in other orders
on the two sides: held within a relative L2 of 1e-2 (a sliding layer that
attends one slot too many moves them by far more: see
test_window_changes_logits)."""

import dataclasses
import http.client
import json
import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.gguf.constants import GGMLType
from rrs_tpu.models import loader as jax_loader
from rrs_tpu.models.config import PRESETS as JAX_PRESETS
from rrs_tpu.models.export import export_random_gguf
from rrs_tpu.runtime.context import InferenceContext as JaxContext
from rrs_tpu_torch.models import llama
from rrs_tpu_torch.models.config import PRESETS, ModelConfig
from rrs_tpu_torch.models.linear import DenseLinear
from rrs_tpu_torch.models.loader import load_model
from rrs_tpu_torch.ops.basic import RopeParams, apply_rope, rope_frequencies
from rrs_tpu_torch.runtime.context import InferenceContext
from rrs_tpu_torch.runtime.kv_cache import KVCache

from test_torch_common import linear_tree, tiny_vocab_tokens, torch_cfg, weights_tree

YARN = {"gpt-oss.rope.scaling.type": "yarn", "gpt-oss.rope.scaling.factor": 4.0,
        "gpt-oss.rope.scaling.original_context_length": 64}
LOGITS_TOL = 1e-2


def rel_l2(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.fixture(scope="module")
def oss_gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_gptoss") / "tiny-oss-mxfp4.gguf"
    export_random_gguf(JAX_PRESETS["tiny-oss"], path, seed=0, expert_ggml_type=GGMLType.MXFP4,
                       vocab_tokens=tiny_vocab_tokens(512))
    return path


# -- YaRN ---------------------------------------------------------------------

@pytest.mark.parametrize("p", [
    dict(head_dim=64, theta=150000.0, scaling_type="yarn", scale_factor=32.0, orig_context=4096),
    dict(head_dim=32, theta=10000.0, scaling_type="yarn", scale_factor=4.0, orig_context=64),
], ids=["gpt-oss-20b", "tiny"])
def test_rope_scaling_matches_jax(p):
    from rrs_tpu.ops.basic import RopeParams as JaxRope
    from rrs_tpu.ops.basic import apply_rope as jax_apply
    from rrs_tpu.ops.basic import rope_frequencies as jax_freq

    jp, tp = JaxRope(**p), RopeParams(**p)
    np.testing.assert_allclose(rope_frequencies(tp).numpy(), np.asarray(jax_freq(jp)),
                               rtol=1e-6, atol=0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, p["head_dim"])).astype(np.float32)
    pos = rng.integers(0, 16384, (2, 7)).astype(np.int32)
    ref = np.asarray(jax_apply(jnp.asarray(x), jnp.asarray(pos), jp))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tp).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4 * np.abs(ref).max())


def test_rope_params_per_layer_match_jax():
    from rrs_tpu.models.llama import rope_params as jax_rope_params

    for name in ("gpt-oss-20b", "tiny-oss"):
        jcfg = JAX_PRESETS[name]
        for swa in (False, True):
            for theta_swa in (0.0, 10000.0):
                j = jax_rope_params(dataclasses.replace(jcfg, rope_theta_swa=theta_swa), swa=swa)
                t = llama.rope_params(dataclasses.replace(PRESETS[name],
                                                          rope_theta_swa=theta_swa), swa=swa)
                assert {f.name: getattr(t, f.name) for f in dataclasses.fields(t)} == \
                    {f.name: getattr(j, f.name) for f in dataclasses.fields(t)}


def test_presets_and_swa_layers_match_jax():
    for name in ("gpt-oss-20b", "tiny-oss"):
        jcfg, tcfg = JAX_PRESETS[name], PRESETS[name]
        assert torch_cfg(jcfg) == tcfg
        assert [tcfg.is_swa(li) for li in range(tcfg.n_layers)] == \
            [jcfg.is_swa(li) for li in range(jcfg.n_layers)]
        assert tcfg.any_swa and tcfg.is_swa(0) and not tcfg.is_swa(1)


# -- the ring store -------------------------------------------------------------

@pytest.mark.parametrize("quant", ["none", "q8"])
@pytest.mark.parametrize("t", [1, 6], ids=["decode", "wrapping chunk"])
def test_ring_store_matches_jax(quant, t):
    """Three lanes on a 16-slot ring with window 4: lane 0 from position 13
    (a 6-row chunk wraps to slots 0-2), lane 1 from 30 (slot 14), lane 2
    padded. The live lanes' slots equal JAX's one-hot ring rewrite (T > 1) or
    its update slice (T = 1), codes and scales bit for bit (at T = 1 JAX
    blends the new q8 scale in, within 1e-5). The padded lane's ring is left
    as it was: JAX's ring rewrite multiplies it out at T > 1; at T = 1 JAX
    parks its row in the top slot, which on a ring may hold a live window,
    and the port writes nothing there either."""
    from rrs_tpu.models.llama import _store_cache as jstore

    rng = np.random.default_rng(3)
    init = rng.standard_normal((3, 2, 16, 32)).astype(np.float32)
    if quant == "none":
        jc = jnp.asarray(init, jnp.bfloat16)
        tc = (torch.from_numpy(np.array(jc.astype(jnp.float32))).to(torch.bfloat16),)
    else:
        from rrs_tpu_torch.runtime import kv_codec

        q, s = kv_codec.quantize_rows(torch.from_numpy(init), 127.0)
        tc = (q.contiguous(), s[:, :, None, :].contiguous())
        jc = (jnp.asarray(tc[0].numpy()), jnp.asarray(tc[1].numpy()))
    new = rng.standard_normal((3, 2, t, 32)).astype(np.float32)
    first = np.array([13, 30, -1], np.int32)
    slots = np.where(first[:, None] < 0, 15, first[:, None] + np.arange(t, dtype=np.int32))
    mask = np.where(first[:, None] < 0, -1, slots).astype(np.int32)
    jnew = jnp.asarray(new, jnp.bfloat16 if quant == "none" else jnp.float32)
    ref = jstore(jc, jnew, jnp.asarray(slots), jnp.asarray(mask), window=4)
    ref = ref if isinstance(ref, tuple) else (ref,)
    lane_slots = llama._lane_slots(torch.from_numpy(slots), torch.from_numpy(mask))
    starts = llama._layer_starts(lane_slots, 16, t, ring=True)
    assert starts == [13, 14, None]
    before = [c.float().numpy().copy() for c in tc]
    tnew = torch.from_numpy(np.array(jnew.astype(jnp.float32))).to(tc[0].dtype
                                                                   if quant == "none" else
                                                                   torch.float32)
    llama._store_cache(tc if quant != "none" else tc[0], tnew, starts)
    for i, (g, w) in enumerate(zip(tc, ref)):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if i == 1 and t == 1:
            np.testing.assert_allclose(g[:2], w[:2], rtol=1e-5, atol=0)
        else:
            np.testing.assert_array_equal(g[:2], w[:2])
        np.testing.assert_array_equal(g[2], before[i][2])             # padded lane untouched
        if t > 1:
            np.testing.assert_array_equal(w[2], before[i][2])
    if t > 1:
        # lane 0's rows for positions 16-18 wrapped into slots 0-2
        assert not np.array_equal(tc[0][0, :, :3].float().numpy(), before[0][0, :, :3])
        assert np.array_equal(tc[0][0, :, 3:13].float().numpy(), before[0][0, :, 3:13])


def test_kv_cache_rings_and_no_shift():
    """Sliding layers get round_up(window + max_chunk, 128) slots, as JAX's
    cache gives them; a context shift refuses a model with sliding layers."""
    from rrs_tpu.runtime.kv_cache import KVCache as JaxKV

    for name, max_seq, chunk in (("gpt-oss-20b", 4096, 512), ("tiny-oss", 1024, 512),
                                 ("tiny-oss", 128, 128)):
        jkv = JaxKV.create(JAX_PRESETS[name], 1, max_seq, max_chunk=chunk) \
            if name == "tiny-oss" else None
        tkv = KVCache.create(PRESETS[name], 1, max_seq, device="meta", max_chunk=chunk)
        if jkv is not None:
            assert tkv.sizes == jkv.sizes
        assert [c.shape[2] for c in tkv.k] == tkv.sizes
    assert KVCache.create(PRESETS["gpt-oss-20b"], 1, 4096, device="meta").sizes[:2] == [640, 4096]
    kv = KVCache.create(PRESETS["tiny-oss"], 1, 64)
    kv.seq_new(0)
    kv.lengths[0] = 20
    with pytest.raises(RuntimeError, match="SWA"):
        kv.seq_shift(PRESETS["tiny-oss"], 0, 1, 10)


# -- the tiny gpt-oss model -------------------------------------------------------

def test_gguf_loads_equal_in_both_packages(oss_gguf):
    jcfg, jw, _ = jax_loader.load_model(oss_gguf, overrides=YARN)
    cfg, w, _ = load_model(oss_gguf, device="cpu", overrides=YARN)
    assert cfg == torch_cfg(jcfg)
    assert cfg.rope_scaling_type == "yarn" and cfg.any_swa and cfg.n_experts == 4
    for jl, tl in zip(jw.layers, w.layers):
        jm, tm = jl.moe, tl.moe
        assert jm.quant_kind == tm.quant_kind == "mxfp4"
        for f in ("gate_qs", "gate_eff", "up_qs", "up_eff", "down_qs", "down_eff", "router_bias",
                  "gate_b", "up_b", "down_b"):
            np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)))
        np.testing.assert_array_equal(tm.router.float().numpy(), np.asarray(jm.router, np.float32))
        np.testing.assert_array_equal(tl.attn_sinks.numpy(), np.asarray(jl.attn_sinks))
        np.testing.assert_array_equal(tl.ffn_norm.float().numpy(),
                                      np.asarray(jl.ffn_norm, np.float32))
        assert isinstance(tl.wqkv, DenseLinear) and tl.wqkv.bias is not None
        np.testing.assert_array_equal(tl.wqkv.bias.numpy(), np.asarray(jl.wqkv.bias))
        np.testing.assert_array_equal(tl.wo.bias.numpy(), np.asarray(jl.wo.bias))
        assert tl.w_gate is tl.w_up is tl.w_down is tl.w_gateup is None


def test_weights_from_numpy_carries_moe_sinks_and_mxfp4(oss_gguf):
    from rrs_tpu.models.linear import MXFP4Linear as JaxMX
    from rrs_tpu_torch.models.linear import MXFP4Linear

    jcfg, jw, _ = jax_loader.load_model(oss_gguf)
    # one MXFP4 linear crosses too (the attention output, K = n_q_dim)
    rng = np.random.default_rng(0)
    from rrs_tpu.formats.kquants import quantize_mxfp4

    n, k = jcfg.n_embd, jcfg.n_q_dim
    jw.layers[1].wo = JaxMX.from_gguf(quantize_mxfp4(
        rng.standard_normal((n, k)).astype(np.float32)), (n, k),
        bias=rng.standard_normal(n).astype(np.float32))
    tw = llama.weights_from_numpy(torch_cfg(jcfg), weights_tree(jw), device="cpu")
    for jl, tl in zip(jw.layers, tw.layers):
        tree = linear_tree(jl.moe)
        for f, v in tree.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(getattr(tl.moe, f).float().numpy(),
                                              np.asarray(v, np.float32))
        np.testing.assert_array_equal(tl.attn_sinks.numpy(), np.asarray(jl.attn_sinks))
    wo = tw.layers[1].wo
    assert isinstance(wo, MXFP4Linear) and wo.n_logical == n and wo.qs.shape == (k // 2, 128)
    np.testing.assert_array_equal(wo.qs.numpy(), np.asarray(jw.layers[1].wo.qs))
    np.testing.assert_array_equal(wo.scale.numpy(), np.asarray(jw.layers[1].wo.scale))
    np.testing.assert_array_equal(wo.bias.numpy(), np.asarray(jw.layers[1].wo.bias))


@pytest.mark.parametrize("n_prompt", [40, 700], ids=["all-experts prefill",
                                                     "capacity prefill, rings wrap"])
def test_logits_and_greedy_tokens_match_jax(oss_gguf, n_prompt):
    """Prefill (the 40-token prompt lands in the 64 bucket: B13 over shared
    activations; 700 tokens in chunks of 512 and 188: the capacity dispatch,
    and past the 640-slot rings of the sliding layers), then two greedy
    decode steps (B12), on a 1024-slot context, against the JAX context."""
    jcfg, jw, _ = jax_loader.load_model(oss_gguf, overrides=YARN)
    cfg, w, _ = load_model(oss_gguf, device="cpu", overrides=YARN)
    prompt = [int(t) for t in np.random.default_rng(n_prompt).integers(0, 512, n_prompt)]
    runs = []
    with jax.disable_jit():
        jctx = JaxContext(jcfg, jw, n_lanes=1, max_seq=1024)
        tctx = InferenceContext(cfg, w, n_lanes=1, max_seq=1024, device="cpu")
        assert tctx.kv.sizes == jctx.kv.sizes == [640, 1024, 640]
        for ctx, to_np in ((jctx, lambda a: np.asarray(a, np.float32)),
                           (tctx, lambda a: a.float().numpy())):
            seq = ctx.new_sequence()
            logits = [to_np(ctx.prefill(seq, prompt, all_logits=False)[-1])]
            toks = []
            for _ in range(2):
                toks.append(int(np.argmax(logits[-1])))
                logits.append(to_np(ctx.decode({seq: toks[-1]})[seq]))
            runs.append((logits, toks))
    (jl, jt), (tl, tt) = runs
    for stage, (g, r) in enumerate(zip(tl, jl)):
        assert np.isfinite(g).all()
        assert rel_l2(g, r) < LOGITS_TOL, (stage, rel_l2(g, r))
    assert tt == jt


def test_window_changes_logits(oss_gguf):
    """The logits tolerance is meaningful: widening the sliding window from
    8 to 9 moves the 40-token prefill's last logits by far more than it."""
    cfg, w, _ = load_model(oss_gguf, device="cpu", overrides=YARN)
    prompt = list(range(40))
    out = []
    for c in (cfg, dataclasses.replace(cfg, swa_window=9)):
        ctx = InferenceContext(c, w, n_lanes=1, max_seq=128, device="cpu")
        out.append(ctx.prefill(ctx.new_sequence(), prompt)[-1].numpy())
    assert rel_l2(out[1], out[0]) > 10 * LOGITS_TOL


# -- serving --------------------------------------------------------------------

def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request(method, path, json.dumps(body) if body is not None else None,
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data


def test_server_answers_gpt_oss_on_cpu(oss_gguf):
    """The engine over the tiny gpt-oss model on the CPU: a completion and a
    chat completion (the gpt-oss chat format) finish with their token counts;
    a released lane is freed, not kept as a prompt cache (its rings no longer
    hold the prefix); a request that runs into the context finishes by length
    at the limit instead of shifting."""
    from rrs_tpu_torch.models.vocab import Vocab
    from rrs_tpu_torch.serving.engine import Engine
    from rrs_tpu_torch.serving.server import ServerState, make_handler

    cfg, w, md = load_model(oss_gguf, device="cpu")
    ctx = InferenceContext(cfg, w, n_lanes=2, max_seq=96, device="cpu")
    engine = Engine(ctx)
    vocab = Vocab.from_gguf(md)
    state = ServerState(cfg, vocab, engine, md, "tiny-oss")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    engine.start()
    try:
        status, data = _http(port, "POST", "/v1/completions",
                             {"prompt": "abcdefghij", "max_tokens": 6, "temperature": 0.0})
        out = json.loads(data)
        assert status == 200 and out["usage"]["completion_tokens"] == 6
        assert out["choices"][0]["finish_reason"] == "length"
        status, data = _http(port, "POST", "/v1/chat/completions",
                             {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4})
        assert status == 200, data
        assert json.loads(data)["choices"][0]["finish_reason"] in ("length", "stop")
        assert all(s is None for s in ctx.kv.seq_ids) and not ctx.kv.retained
        status, data = _http(port, "POST", "/v1/completions",
                             {"prompt": "x" * 80, "max_tokens": 40, "temperature": 0.0})
        out = json.loads(data)
        assert status == 200 and out["choices"][0]["finish_reason"] == "length"
        assert out["usage"]["completion_tokens"] < 40
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()


def test_next_slice_archs_raise():
    """A qwen3 file with MoE layers reads as JAX reads it (MoE layers in a
    dense architecture, which raised here, are ported); the multimodal
    qwen2vl, which raised here naming ROADMAP A11, reads as JAX reads it,
    with its M-RoPE sections (the recurrent architectures, which raised
    here naming A9b, are ported: tests/test_torch_rwkv.py checks rwkv6's
    config); qwen3 with a window slides every layer. (qwen2moe, which raised
    here, is ported: its config is checked in tests/test_torch_qwen2moe.py.)"""
    from rrs_tpu.models.config import ModelConfig as JaxConfig

    from test_torch_common import torch_cfg

    md = {"general.architecture": "qwen3", "qwen3.block_count": 2,
          "qwen3.embedding_length": 64, "qwen3.expert_count": 8}
    cfg = ModelConfig.from_gguf(md)
    assert cfg == torch_cfg(JaxConfig.from_gguf(md)) and cfg.n_experts == 8
    md = {"general.architecture": "qwen2vl", "qwen2vl.block_count": 2,
          "qwen2vl.embedding_length": 64, "qwen2vl.rope.dimension_sections": [2, 3, 3, 0]}
    cfg = ModelConfig.from_gguf(md)
    assert cfg == torch_cfg(JaxConfig.from_gguf(md)) and cfg.rope_sections == (2, 3, 3, 0)
    md = {"general.architecture": "qwen3", "qwen3.block_count": 2, "qwen3.embedding_length": 64,
          "qwen3.attention.head_count": 4, "qwen3.attention.sliding_window": 32}
    cfg = ModelConfig.from_gguf(md)
    assert (cfg.swa_window, cfg.swa_pattern) == (32, 1) and cfg.is_swa(1)
