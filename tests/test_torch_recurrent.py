"""The recurrent and hybrid families (Mamba, Falcon-Mamba, Jamba) through
rrs_tpu_torch against rrs_tpu: files, contexts, the engine and the server.
RWKV6 has its own file, tests/test_torch_rwkv.py.

The files are 2 layers at E = 256 (d_inner 512, d_state 16, dt_rank 16, a
256-token char vocabulary): Mamba written by JAX's exporter, its norms drawn
around 1 by a rewrite with JAX's writer; Falcon-Mamba the same file under
``falcon_mamba`` with ``ssm.dt_b_c_rms``; Jamba written with JAX's writer
(a Mamba layer with dt / B / C norms and an MoE FFN of 4 experts top-2, then
an attention layer, 4 / 2 heads x 64, with a dense FFN). The JAX package
loads through its NumPy route.

Held: the config field by field; 40-token prefill logits (two exact chunks,
32 + 8) at rel L2 <= 1e-2 and elementwise within 2e-2 of the largest logit,
both packages on the same bf16 weights (the port's log-step scan and JAX's
associative scan round apart by ~1e-6, below one bf16 step); greedy tokens
identical (up to a bf16 tie in JAX's own logits); a TCQ4 Mamba file from
JAX's quantizer under the same greedy rule, and a TCQ4 Jamba file's MoE
layer, which takes n_ff where the file carries no expert width; the contexts (decode against
prefill within JAX's 3e-2, lanes, ``seq_cp`` / ``seq_keep``, the
mid-sequence ``seq_rm`` raising, ``embed`` equal to JAX's, ``make_context``
choosing JAX's classes); the engine's full-prefix prompt-cache reuse and
its mismatch restart; ``/v1/completions`` through the router's
``ModelHandle`` greedy text equal to JAX's server; and the one departure:
Falcon-Mamba's weightless dt / B / C norms, which JAX reads and never
applies (ROADMAP queue C). The JAX package runs jitted (op by op, its
associative scan takes seconds a chunk), once per file.
"""

import dataclasses
import http.client
import json
import queue
import threading
from http.server import ThreadingHTTPServer
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
from rrs_tpu.runtime import recurrent as jax_recurrent
from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.models.loader import load_model
from rrs_tpu_torch.runtime import recurrent
from rrs_tpu_torch.runtime.hybrid import HybridContext

from test_torch_common import (assert_same_greedy, rewrite_gguf, tiny_vocab_tokens,
                               torch_cfg)

E, DI, DS, DTR = 256, 512, 16, 16
PROMPT = [int(t) for t in np.random.default_rng(3).integers(0, 256, 40)]
REL_L2 = 1e-2


def mamba_cfg(arch="mamba"):
    return JaxConfig(arch=arch, n_layers=2, n_embd=E, n_heads=0, n_kv_heads=0, head_dim=0,
                     n_ff=0, vocab_size=256, context_length=512, rms_eps=1e-5, ssm_d_conv=4,
                     ssm_d_inner=DI, ssm_d_state=DS, ssm_dt_rank=DTR)


def _norms_around_one(seed):
    rng = np.random.default_rng(seed)

    def edit(name, arr):
        if name.endswith("norm.weight"):
            return {name: (1.0 + 0.3 * rng.standard_normal(arr.shape)).astype(np.float32)}
        return {} if name == "" else {name: arr}
    return edit


def write_jamba(path):
    """2-layer jamba: layer 0 Mamba (dt / B / C norms) + 4 experts top-2,
    layer 1 attention (no RoPE) + a dense FFN; norms around 1."""
    from rrs_tpu.gguf.writer import GGUFWriter

    rng = np.random.default_rng(8)
    a, f, n_exp = "jamba", 512, 4
    w = GGUFWriter(path)
    w.add_string("general.architecture", a)
    for k, v in (("block_count", 2), ("context_length", 512), ("embedding_length", E),
                 ("feed_forward_length", f), ("attention.head_count", 4),
                 ("attention.head_count_kv", 2), ("attention.key_length", 64),
                 ("ssm.conv_kernel", 4), ("ssm.inner_size", DI), ("ssm.state_size", DS),
                 ("ssm.time_step_rank", DTR), ("vocab_size", 256), ("expert_count", n_exp),
                 ("expert_used_count", 2)):
        w.add_uint32(f"{a}.{k}", v)
    w.add_float32(f"{a}.attention.layer_norm_rms_epsilon", 1e-6)
    w.add_string("tokenizer.ggml.model", "gpt2")
    w.add_array("tokenizer.ggml.tokens", tiny_vocab_tokens(256))

    def t(name, shape, s=0.05):
        w.add_tensor(name, (rng.standard_normal(shape) * s).astype(np.float32))

    def norm(name, n):
        w.add_tensor(name, (1.0 + 0.3 * rng.standard_normal(n)).astype(np.float32))

    t("token_embd.weight", (256, E))
    norm("blk.0.attn_norm.weight", E)
    t("blk.0.ssm_in.weight", (2 * DI, E))
    t("blk.0.ssm_conv1d.weight", (DI, 4), 0.3)
    t("blk.0.ssm_conv1d.bias", (DI,))
    t("blk.0.ssm_x.weight", (DTR + 2 * DS, DI))
    t("blk.0.ssm_dt.weight", (DI, DTR), 0.2)
    t("blk.0.ssm_dt.bias", (DI,), 0.2)
    w.add_tensor("blk.0.ssm_a", (-np.exp(rng.standard_normal((DI, DS)) * 0.5)).astype(np.float32))
    w.add_tensor("blk.0.ssm_d", np.ones((DI,), np.float32))
    norm("blk.0.ssm_dt_norm.weight", DTR)
    norm("blk.0.ssm_b_norm.weight", DS)
    norm("blk.0.ssm_c_norm.weight", DS)
    t("blk.0.ssm_out.weight", (E, DI))
    norm("blk.0.ffn_norm.weight", E)
    t("blk.0.ffn_gate_inp.weight", (n_exp, E), 0.3)
    t("blk.0.ffn_gate_exps.weight", (n_exp, f, E))
    t("blk.0.ffn_up_exps.weight", (n_exp, f, E))
    t("blk.0.ffn_down_exps.weight", (n_exp, E, f))
    norm("blk.1.attn_norm.weight", E)
    t("blk.1.attn_q.weight", (256, E))
    t("blk.1.attn_k.weight", (128, E))
    t("blk.1.attn_v.weight", (128, E))
    t("blk.1.attn_output.weight", (E, 256))
    norm("blk.1.ffn_norm.weight", E)
    t("blk.1.ffn_gate.weight", (f, E))
    t("blk.1.ffn_up.weight", (f, E))
    t("blk.1.ffn_down.weight", (E, f))
    norm("output_norm.weight", E)
    t("output.weight", (256, E))
    w.write()
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from rrs_tpu.quantize.quantizer import quantize_model as jax_quantize

    d = tmp_path_factory.mktemp("torch_recurrent")
    out = {}
    for arch, kv in (("mamba", {}), ("falcon_mamba", {"falcon_mamba.ssm.dt_b_c_rms": True})):
        src = d / f"{arch}-export.gguf"
        export_random_gguf(mamba_cfg(arch), src, seed=1, vocab_tokens=tiny_vocab_tokens(256))
        out[arch] = rewrite_gguf(src, d / f"{arch}.gguf", kv=kv, edit=_norms_around_one(2))
    out["jamba"] = write_jamba(d / "jamba.gguf")
    for name in ("mamba", "jamba"):
        out[f"{name}-tcq4"] = d / f"{name}-tcq4.gguf"
        jax_quantize(out[name], out[f"{name}-tcq4"], verbose=False)
    return out


def jax_load(path, overrides=None):
    with mock.patch.object(jax_native, "available", lambda: False):
        return jax_loader.load_model(path, overrides=overrides)


_JAX_RUNS: dict = {}


def jax_run(path, prompt=tuple(PROMPT), n_new=6):
    """JAX's greedy tokens and its teacher-forced logits over prompt +
    tokens (jitted: op by op, its associative scan takes seconds a chunk),
    once per file."""
    key = (str(path), tuple(prompt), n_new)
    if key not in _JAX_RUNS:
        jcfg, jw, _ = jax_load(path)
        ctx = jax_recurrent.make_context(jcfg, jw, n_lanes=1, max_seq=128)
        toks = ctx.generate(list(prompt), n_new)
        seq = ctx.new_sequence()
        forced = np.asarray(ctx.prefill(seq, list(prompt) + toks[:-1]), np.float32)
        ctx.kv.seq_rm(seq)
        _JAX_RUNS[key] = jcfg, jw, toks, forced, ctx
    return _JAX_RUNS[key]


def port_ctx(path, n_lanes=1):
    cfg, w, _ = load_model(path, device="cpu")
    return recurrent.make_context(cfg, w, n_lanes=n_lanes, max_seq=128, device="cpu")


@pytest.mark.parametrize("name", ["mamba", "falcon_mamba", "jamba"])
def test_config_matches_jax(files, name):
    from rrs_tpu.gguf.reader import read_gguf as jax_read_gguf

    g = jax_read_gguf(files[name])
    md = dict(g.metadata)
    g.close()
    cfg = ModelConfig.from_gguf(md)
    assert cfg == torch_cfg(JaxConfig.from_gguf(md))
    assert (cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_dt_rank, cfg.ssm_d_conv) == (DI, DS, DTR, 4)
    assert cfg.ssm_dt_b_c_rms == (name == "falcon_mamba")
    assert cfg.is_hybrid == (name == "jamba") == cfg.no_rope
    assert cfg.is_recurrent == (name != "jamba")


@pytest.mark.parametrize("name", ["mamba", "jamba"])
def test_logits_and_greedy_tokens_match_jax(files, name):
    _, _, ref_toks, forced, _ = jax_run(files[name])
    ctx = port_ctx(files[name])
    assert type(ctx).__name__ == ("HybridContext" if name == "jamba" else "RecurrentContext")
    if name == "jamba":
        assert [hl.kind for hl in ctx.weights.layers] == ["ssm", "attn"]
        lw = ctx.weights.layers[0]
        assert lw.moe is not None and lw.ssm.dt_norm is not None
    got = ctx.prefill(ctx.new_sequence(), PROMPT).float().numpy()
    ref = forced[:len(PROMPT)]
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= REL_L2
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()
    toks = port_ctx(files[name]).generate(PROMPT, 6)
    assert_same_greedy(toks, ref_toks, forced[len(PROMPT) - 1:])


def test_w4a4_mamba_greedy_tokens_match_jax(files):
    """ssm_in, ssm_x and ssm_out TCQ4_K32 by JAX's quantizer (ssm_dt at K =
    16 stays f32), both packages on the NumPy decode's bits: greedy tokens
    under the queue-C rule (identical up to a bf16 tie in JAX's logits).
    JAX runs jitted here, where XLA may keep f32 excess precision through a
    fused bf16 chain and so flip an int4 code (queue C's reason for
    ``jax.disable_jit``, under which its scan and kernels take minutes); on
    this file no code flips."""
    _, jw, ref_toks, forced, _ = jax_run(files["mamba-tcq4"])
    ctx = port_ctx(files["mamba-tcq4"])
    lw = ctx.weights.layers[0]
    assert [type(getattr(lw, f)).__name__ for f in ("w_in", "w_x", "w_dt", "w_out")] == \
        ["TCQ4Linear", "TCQ4Linear", "DenseLinear", "TCQ4Linear"]
    toks = ctx.generate(PROMPT, 6)
    assert_same_greedy(toks, ref_toks, forced[len(PROMPT) - 1:])


def test_tcq4_jamba_experts_take_n_ff(files):
    """A jamba file quantized by JAX's quantizer (TCQ4 projections and expert
    stacks) carries no ``expert_feed_forward_length``: JAX's packed experts
    slice their outputs to that width, 0, and fail; the port takes n_ff
    (ROADMAP queue C). Its MoE layer at a decode-sized 4 tokens (the rows
    branch) equals JAX's given the width as an override, bit for bit, and
    the whole TCQ4 model generates."""
    from rrs_tpu.models import moe as jax_moe
    from rrs_tpu_torch.models import moe

    jcfg, jw, _ = jax_load(files["jamba-tcq4"], {"jamba.expert_feed_forward_length": 512})
    ctx = port_ctx(files["jamba-tcq4"])
    mw = ctx.weights.layers[0].moe
    assert ctx.cfg.n_ff_exp == 0 and mw.quant_kind == "tcq4"
    x = (np.random.default_rng(9).standard_normal((1, 4, E)) * 0.5).astype(np.float32)
    ref = jax_moe.moe_ffn(jcfg, jw.layers[0].moe, jnp.asarray(x, jnp.bfloat16))
    got = moe.moe_ffn(ctx.cfg, mw, torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    out = ctx.generate(PROMPT, 4)
    assert len(out) == 4 and all(0 <= t < 256 for t in out)


def _falcon_jax_weights_with_unit_norms(jcfg, jw):
    """JAX's Falcon-Mamba weights with unit dt / B / C norm weights, on which
    JAX's mamba_block applies the norms: the published model's weightless
    norms."""
    one = lambda n: jnp.ones((n,), jnp.bfloat16)       # noqa: E731
    layers = [dataclasses.replace(lw, dt_norm=one(DTR), b_norm=one(DS), c_norm=one(DS))
              for lw in jw.layers]
    return dataclasses.replace(jw, layers=layers)


def test_falcon_mamba_norms_where_jax_skips_them(files):
    """The departure (ROADMAP queue C): with ``ssm.dt_b_c_rms`` and no norm
    weights, the port applies the weightless RMS norm to dt / B / C, as the
    published Falcon-Mamba does, and JAX applies none. The port's logits
    equal JAX's forward given unit norm weights, and part from JAX's own by
    far more than the tolerance; the same file without the flag (plain
    mamba) agrees with JAX (test_logits_and_greedy_tokens_match_jax)."""
    jcfg, jw, _ = jax_load(files["falcon_mamba"])
    assert jcfg.ssm_dt_b_c_rms and jw.layers[0].dt_norm is None
    jfix = _falcon_jax_weights_with_unit_norms(jcfg, jw)
    refs = {}
    for label, w in (("jax", jw), ("published", jfix)):
        ctx = jax_recurrent.make_context(jcfg, w, n_lanes=1, max_seq=128)
        refs[label] = np.asarray(ctx.prefill(ctx.new_sequence(), PROMPT), np.float32)
    ctx = port_ctx(files["falcon_mamba"])
    got = ctx.prefill(ctx.new_sequence(), PROMPT).float().numpy()
    rel = {k: np.linalg.norm(got - r) / np.linalg.norm(r) for k, r in refs.items()}
    assert rel["published"] <= REL_L2 and rel["jax"] > 10 * REL_L2, rel


@pytest.mark.parametrize("name", ["mamba", "jamba"])
def test_decode_matches_prefill_and_lanes(files, name):
    """Token-by-token decode against an all-at-once prefill (JAX's 3e-2,
    tests/test_mamba.py, tests/test_hybrid.py); on a 2-lane context, a
    second sequence decoding beside the first leaves its logits as they
    were alone (an inactive lane keeps its state)."""
    toks = PROMPT[:6]
    ctx1 = port_ctx(files[name])
    full = ctx1.prefill(ctx1.new_sequence(), toks).float().numpy()
    ctx2 = port_ctx(files[name], n_lanes=2)
    s = ctx2.new_sequence()
    other = ctx2.new_sequence()
    ctx2.prefill(other, PROMPT[10:15])
    step = [ctx2.prefill(s, toks[:1])[0].float().numpy()]
    for i, tok in enumerate(toks[1:]):
        batch = {s: tok, other: PROMPT[15 + i]} if i % 2 else {s: tok}
        step.append(ctx2.decode(batch)[s].float().numpy())
    np.testing.assert_allclose(np.stack(step), full, rtol=3e-2, atol=3e-2)
    assert ctx2.kv.lengths == [6, 5 + 2]


@pytest.mark.parametrize("name", ["mamba", "jamba"])
def test_cache_lane_operations(files, name):
    """seq_cp forks a lane (the fork's next logits equal the source's),
    seq_keep drops every other lane, a mid-sequence seq_rm raises as the JAX
    memory's does, seq_rm past the end removes nothing, and the context
    shift raises."""
    ctx = port_ctx(files[name], n_lanes=3)
    jcfg, jw, _ = jax_load(files[name])
    jctx = jax_recurrent.make_context(jcfg, jw, n_lanes=3, max_seq=128)
    for c in (ctx, jctx):
        s = c.new_sequence()
        c.prefill(s, PROMPT[:5])
        c.kv.seq_cp(s, 99)
        assert c.kv.lengths[c.kv.lane_of(99)] == 5
        with pytest.raises(RuntimeError):
            c.kv.seq_rm(s, p0=2)
        c.kv.seq_rm(s, p0=5)
        assert c.kv.has_seq(s)
        with pytest.raises(RuntimeError):
            c.kv.seq_shift(c.cfg, s, 1, 1)
    a = ctx.decode({0: 7, 99: 7})
    np.testing.assert_array_equal(a[0].numpy(), a[99].numpy())
    ctx.kv.seq_keep(99)
    assert ctx.kv.seq_ids.count(None) == 2 and ctx.kv.has_seq(99)


def test_make_context_and_embed_match_jax(files, tmp_path):
    """make_context picks JAX's class for each memory (an attention file
    takes InferenceContext); ``embed`` pools the recurrent state as JAX's
    does (the last Mamba layer's ssm state, or the first one of a hybrid,
    averaged over d_state), within 1e-2 of its largest entry (the states
    are f32 sums of bf16 activations that may part by one bf16 step)."""
    from test_torch_common import jax_cfg

    attn = export_random_gguf(jax_cfg(), tmp_path / "qwen3.gguf", seed=0,
                              vocab_tokens=tiny_vocab_tokens(256))
    for path, cls in ((files["mamba"], "RecurrentContext"), (files["jamba"], "HybridContext"),
                      (attn, "InferenceContext")):
        cfg, w, _ = load_model(path, device="cpu")
        got = recurrent.make_context(cfg, w, max_seq=64, device="cpu")
        if cls == "InferenceContext":
            jcfg, jw, _ = jax_load(path)
            ref = jax_recurrent.make_context(jcfg, jw, max_seq=64)
        else:
            ref = jax_run(path)[4]            # compiled already
        assert type(got).__name__ == type(ref).__name__ == cls
        if cls != "InferenceContext":
            e, je = got.embed(PROMPT), np.asarray(ref.embed(PROMPT))
            assert e.shape == je.shape == (DI,) and e.dtype == np.float32
            assert np.abs(e - je).max() <= 1e-2 * np.abs(je).max()
            assert got.kv.seq_ids == [None]


def test_state_save_is_refused(files, tmp_path):
    """Slot files have no format for a recurrent or hybrid memory (JAX's
    save fails on the missing K/V layers): the port says so."""
    from rrs_tpu_torch.runtime import state

    for name in ("mamba", "jamba"):
        ctx = port_ctx(files[name])
        seq = ctx.new_sequence()
        ctx.prefill(seq, PROMPT[:3])
        with pytest.raises(NotImplementedError, match="recurrent or hybrid"):
            state.save_sequence(ctx, seq, tmp_path / "slot.bin")
        with pytest.raises(NotImplementedError, match="recurrent or hybrid"):
            state.save_state(ctx, tmp_path / "all.bin")


def _run_engine(eng, prompt, max_tokens=2):
    from rrs_tpu_torch.runtime.sampler import SamplerParams
    from rrs_tpu_torch.serving.engine import GenRequest

    q = queue.Queue()
    out = []

    def on_token(tok, piece, fin, reason):
        if fin:
            q.put(reason)
        else:
            out.append(tok)
    eng.submit(GenRequest(prompt_tokens=list(prompt), max_tokens=max_tokens, on_token=on_token,
                          params=SamplerParams(temperature=0.0)))
    reason = q.get(timeout=120)
    assert reason in ("stop", "length"), reason
    return out


@pytest.mark.parametrize("name", ["mamba", "jamba"])
def test_engine_prompt_cache_on_recurrent_memory(files, name):
    """tests/test_mamba.py's engine case: a prompt extending the retained
    sequence by its first generated token reuses all of it (the state is
    carried, no rewind), and the continuation equals a fresh prefill's; a
    prompt that parts mid-sequence, a shorter one and a mismatched one
    restart the sequence. The slot never takes a device run or a draft."""
    from rrs_tpu_torch.serving.engine import Engine

    eng = Engine(port_ctx(files[name]))
    eng.start()
    try:
        p = PROMPT[:6]
        g = _run_engine(eng, p)
        ext = p + g[:1] + [5, 9]
        got = _run_engine(eng, ext)
        assert eng.slots[0].n_reused == len(p) + 1
        assert got == port_ctx(files[name]).generate(ext, 2)
        for prompt in (p[:3] + [200, 201], p[:2], [9, 9, 9]):
            _run_engine(eng, prompt)
            assert eng.slots[0].n_reused == 0
        assert eng.n_decode_runs == 0 and eng.n_drafted == 0
    finally:
        eng.stop()


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", "/v1/completions", json.dumps(body), {"Content-Type": "application/json"})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    assert r.status == 200, data
    return json.loads(data)


def test_completions_through_the_router_handle_equal_jax_server(files):
    """``/v1/completions`` on the Mamba file, served by each package's
    router handle (``ModelHandle.load``, which builds its context through
    make_context) and handler: the same greedy text and finish reason, 8
    tokens."""
    from rrs_tpu.serving import server as jax_server
    from rrs_tpu_torch.serving import server

    body = {"prompt": "abcdefgh", "max_tokens": 8, "temperature": 0.0}
    answers = []
    for mod, kw in ((server, {"device": "cpu"}), (jax_server, {})):
        handle = mod.ModelHandle("mamba", str(files["mamba"]), n_lanes=2, max_seq=128, **kw)
        st = handle.load()
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), mod.make_handler(st))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            answers.append(_post(httpd.server_address[1], body))
        finally:
            httpd.shutdown()
            httpd.server_close()
            handle.unload()
    got, ref = answers
    assert got["choices"][0]["text"] == ref["choices"][0]["text"] != ""
    assert got["choices"][0]["finish_reason"] == ref["choices"][0]["finish_reason"]
    assert got["usage"]["completion_tokens"] == 8


SMALL = {
    "mamba": dict(arch="mamba", n_layers=2, n_embd=64, n_heads=0, n_kv_heads=0, head_dim=0,
                  n_ff=0, vocab_size=128, context_length=512, ssm_d_conv=4, ssm_d_inner=128,
                  ssm_d_state=16, ssm_dt_rank=8),
    "rwkv6": dict(arch="rwkv6", n_layers=2, n_embd=64, n_heads=0, n_kv_heads=0, head_dim=0,
                  n_ff=128, vocab_size=96, context_length=512, rwkv_head_size=16,
                  rwkv_tm_extra=8, rwkv_decay_extra=8, rwkv_rescale_every=2),
    "jamba": dict(arch="jamba", n_layers=4, n_embd=64, n_heads=4, n_kv_heads=2, head_dim=16,
                  n_ff=128, vocab_size=96, context_length=256, ssm_d_conv=4, ssm_d_inner=128,
                  ssm_d_state=8, ssm_dt_rank=8, no_rope=True),
}


def _jax_tree(obj):
    """A JAX weights dataclass -> the nested NumPy dict of the port's
    ``weights_from_numpy`` (linears through ``linear_tree``)."""
    from rrs_tpu.models.linear import DenseLinear as JaxDense
    from test_torch_common import linear_tree, to_numpy

    if obj is None or isinstance(obj, str):
        return obj
    if isinstance(obj, JaxDense):
        return linear_tree(obj)
    if dataclasses.is_dataclass(obj):
        return {f.name: _jax_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, list):
        return [_jax_tree(o) for o in obj]
    return to_numpy(obj)


@pytest.mark.parametrize("arch", list(SMALL))
def test_random_weights_and_weights_from_numpy_match_jax(arch):
    """The JAX tests' small configs (tests/test_mamba.py, test_rwkv.py,
    test_hybrid.py): JAX's ``random_weights`` crossed over by
    ``weights_from_numpy`` gives JAX's logits (rel L2 <= 1e-2 on bf16
    weights), and the port's own ``random_weights``, from the same seed and
    draw order (each value rounded to bf16 through f32, where JAX rounds
    once), the same within the same bound; both on 2-lane contexts."""
    from rrs_tpu.models import hybrid as jax_hybrid
    from rrs_tpu.models import mamba as jax_mamba
    from rrs_tpu.models import rwkv6 as jax_rwkv6
    from rrs_tpu_torch.models import hybrid, mamba, rwkv6

    jmod, mod = {"mamba": (jax_mamba, mamba), "rwkv6": (jax_rwkv6, rwkv6),
                 "jamba": (jax_hybrid, hybrid)}[arch]
    kw = {"attn_every": 2} if arch == "jamba" else {}
    jcfg = JaxConfig(**SMALL[arch])
    jw = jmod.random_weights(jcfg, seed=5, **kw)
    toks = [3, 17, 42, 5, 60, 7, 11, 2, 9]
    jctx = jax_recurrent.make_context(jcfg, jw, n_lanes=2, max_seq=64)
    ref = np.asarray(jctx.prefill(jctx.new_sequence(), toks), np.float32)
    cfg = torch_cfg(jcfg)
    for w in (mod.weights_from_numpy(cfg, _jax_tree(jw), device="cpu"),
              mod.random_weights(cfg, seed=5, **kw)):
        ctx = recurrent.make_context(cfg, w, n_lanes=2, max_seq=64, device="cpu")
        got = ctx.prefill(ctx.new_sequence(), toks).float().numpy()
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= REL_L2
