"""InferenceContext(mesh=...) of rrs_tpu_torch against the JAX package's, one
counterpart for each test of tests/test_tp_context.py (and the MLA and
gpt-oss ones of tests/test_mla.py / tests/test_gptoss.py), on the same
meshes: the JAX context on the conftest's virtual CPU devices, compiled
without XLA's excess precision (``exact_jit``), the port's on CPU shards,
both from the same weights. Greedy tokens must be JAX's; logits within 3e-2
(tighter than JAX's own bands against one device, rtol 3e-2 at prefill and
1e-1 at decode). Then the parallel flags of the CLI: generate, serve and
bench with ``--device cpu --tp 2``."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rrs_tpu.models import llama as jllama
from rrs_tpu.models.config import PRESETS as JPRESETS
from rrs_tpu.models.config import ModelConfig as JaxConfig
from rrs_tpu.models.export import export_random_gguf
from rrs_tpu.models.loader import load_model as jax_load_model
from rrs_tpu.parallel.sharding import make_mesh as jax_mesh
from rrs_tpu.runtime.context import InferenceContext as JaxContext
from rrs_tpu_torch.models.llama import weights_from_numpy
from rrs_tpu_torch.models.loader import load_model
from rrs_tpu_torch.parallel.sharding import make_mesh
from rrs_tpu_torch.runtime.context import InferenceContext

from test_torch_common import exact_jit, tiny_vocab_tokens, torch_cfg, weights_tree

ROOT = Path(__file__).resolve().parent.parent
TOL = 3e-2


def _cfg(**over):
    # local K shards (heads * head_dim / tp, n_ff / tp) stay 256-aligned at tp = 4
    return JaxConfig(**{**dict(arch="qwen3", n_layers=2, n_embd=256, n_heads=8, n_kv_heads=4,
                               head_dim=128, n_ff=1024, vocab_size=512, context_length=128,
                               qk_norm=True), **over})


def _port(cfg, w):
    return torch_cfg(cfg), weights_from_numpy(torch_cfg(cfg), weights_tree(w), device="cpu")


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _greedy(ctx, prompt, n_dec):
    """Prefill logits [T, V], then n_dec greedy decode steps' logits [V],
    each side following its own argmax; and the tokens."""
    seq = ctx.new_sequence()
    out = [_np(ctx.prefill(seq, prompt))]
    toks = [int(out[0][-1].argmax())]
    for _ in range(n_dec):
        out.append(_np(ctx.decode({seq: toks[-1]})[seq]))
        toks.append(int(out[-1].argmax()))
    return out, toks


def _hold(got, want):
    """Same greedy tokens, and every logit row within TOL."""
    (gl, gt), (wl, wt) = got, want
    assert gt == wt
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def _both(jcfg, jw, tcfg, tw, n, dp, run, **ctx_kw):
    """run(ctx) on JAX's context over make_mesh(n, dp) and on the port's
    over n CPU shards in dp rows."""
    with exact_jit():
        want = run(JaxContext(jcfg, jw, mesh=jax_mesh(n, dp=dp), **ctx_kw))
    got = run(InferenceContext(tcfg, tw, mesh=make_mesh(devices=["cpu"] * n, dp=dp), **ctx_kw))
    return got, want


def test_tp_context_matches_jax():
    cfg = _cfg()
    w = jllama.random_weights(cfg, seed=3, quantize=True)
    tcfg, tw = _port(cfg, w)
    run = lambda ctx: _greedy(ctx, [1, 2, 3, 4, 5], 4)             # noqa: E731
    got, want = _both(cfg, w, tcfg, tw, 8, 2, run, n_lanes=2, max_seq=64)
    _hold(got, want)
    # and the port's own single-device context, on the same weights
    _hold(got, run(InferenceContext(tcfg, tw, n_lanes=2, max_seq=64, device="cpu")))


def test_tp_context_q8_kv():
    cfg = _cfg()
    w = jllama.random_weights(cfg, seed=5, quantize=True)
    tcfg, tw = _port(cfg, w)
    got, want = _both(cfg, w, tcfg, tw, 4, 1, lambda ctx: _greedy(ctx, [7, 8, 9], 2),
                      n_lanes=1, max_seq=64, kv_quant="q8")
    _hold(got, want)


def test_engine_serves_on_tp_context():
    from rrs_tpu.runtime.sampler import SamplerParams as JaxParams
    from rrs_tpu.serving.engine import Engine as JaxEngine
    from rrs_tpu.serving.engine import GenRequest as JaxRequest
    from rrs_tpu_torch.runtime.sampler import SamplerParams
    from rrs_tpu_torch.serving.engine import Engine, GenRequest

    cfg = _cfg()
    w = jllama.random_weights(cfg, seed=4, quantize=True)
    tcfg, tw = _port(cfg, w)

    def serve(ctx):
        jax_side = isinstance(ctx, JaxContext)
        eng = (JaxEngine if jax_side else Engine)(ctx)
        out, done = [], {}

        def on_token(tok, piece, finished, reason):
            if finished:
                done["r"] = reason
            elif tok is not None:
                out.append(tok)

        eng.submit((JaxRequest if jax_side else GenRequest)(
            prompt_tokens=[1, 2, 3], max_tokens=4,
            params=(JaxParams if jax_side else SamplerParams)(temperature=0.0),
            on_token=on_token))
        for _ in range(100):
            eng._iterate()
            if done:
                break
        assert done.get("r") in ("stop", "length")
        return out

    got, want = _both(cfg, w, tcfg, tw, 8, 2, serve, n_lanes=2, max_seq=64)
    assert len(got) == 4 and got == want


def test_tp_embed_and_embd_prefill():
    cfg = _cfg()
    w = jllama.random_weights(cfg, seed=7, quantize=True)
    tcfg, tw = _port(cfg, w)
    embeds = np.random.default_rng(0).standard_normal((4, cfg.n_embd)).astype(np.float32) * 0.1

    def run(ctx):
        vecs = [np.asarray(ctx.embed([3, 1, 4, 1, 5, 9], pooling=p)) for p in ("mean", "last")]
        seq = ctx.new_sequence()
        rows = _np(ctx.prefill_embeds(seq, embeds))
        return vecs, rows, _np(ctx.decode({seq: 2})[seq])

    (gv, gr, gd), (wv, wr, wd) = _both(cfg, w, tcfg, tw, 4, 1, run, n_lanes=1, max_seq=64)
    for a, b in zip(gv, wv):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    # JAX's own criteria against one device (the last row's argmax, each
    # decode top-1 within 0.1 of the other's max), then every row and the
    # decode step at TOL, under the mesh and on one device: the port's CPU
    # gx epilogue sums its groups in JAX interpret mode's order (ROADMAP C2,
    # where one last-bit difference of B1's plain version had grown to 0.11)
    assert int(gr[-1].argmax()) == int(wr[-1].argmax())
    assert wd[gd.argmax()] >= wd.max() - 0.1 and gd[wd.argmax()] >= gd.max() - 0.1
    np.testing.assert_allclose(gr, wr, rtol=0, atol=TOL)
    np.testing.assert_allclose(gd, wd, rtol=0, atol=TOL)
    sr, sd = run(InferenceContext(tcfg, tw, n_lanes=1, max_seq=64, device="cpu"))[1:]
    np.testing.assert_allclose(gr, sr, rtol=0, atol=TOL)
    np.testing.assert_allclose(gd, sd, rtol=0, atol=TOL)
    np.testing.assert_allclose(sr, wr, rtol=0, atol=TOL)
    np.testing.assert_allclose(sd, wd, rtol=0, atol=TOL)


def _gguf_pair(path, mesh_fuse=False):
    jcfg, jw, _ = jax_load_model(path, fuse=mesh_fuse)
    tcfg, tw, _ = load_model(path, device="cpu", fuse=False)
    return jcfg, jw, tcfg, tw


def test_tp_context_moe(tmp_path):
    """The dense expert stacks split on F (the routed output and the shared
    pair all-reduce): the all-experts prefill (19 tokens) and the gather
    decode."""
    cfg0 = JaxConfig(arch="qwen3moe", n_layers=2, n_embd=128, n_heads=4, n_kv_heads=2,
                     head_dim=64, n_ff=256, vocab_size=512, context_length=128, qk_norm=True,
                     n_experts=4, n_experts_used=2, n_ff_exp=64, norm_topk_prob=True)
    export_random_gguf(cfg0, tmp_path / "moe.gguf", seed=13)
    jcfg, jw, tcfg, tw = _gguf_pair(tmp_path / "moe.gguf")
    got, want = _both(jcfg, jw, tcfg, tw, 2, 1, lambda c: _greedy(c, list(range(1, 20)), 3),
                      n_lanes=1, max_seq=64)
    _hold(got, want)


def test_tp_context_mxfp4_model(tmp_path):
    """MXFP4 attention projections and MXFP4 expert stacks (replicated)."""
    from rrs_tpu.gguf.constants import GGMLType
    from rrs_tpu.quantize.quantizer import quantize_model

    cfg0 = JaxConfig(arch="qwen3moe", n_layers=2, n_embd=256, n_heads=8, n_kv_heads=4,
                     head_dim=128, n_ff=1024, vocab_size=96, context_length=128, qk_norm=True,
                     n_experts=4, n_experts_used=2, n_ff_exp=64, norm_topk_prob=True)
    export_random_gguf(cfg0, tmp_path / "f32.gguf", seed=13, expert_ggml_type=GGMLType.MXFP4)
    quantize_model(str(tmp_path / "f32.gguf"), str(tmp_path / "mx.gguf"), out_type="mxfp4",
                   verbose=False)
    jcfg, jw, tcfg, tw = _gguf_pair(tmp_path / "mx.gguf")
    assert type(tw.layers[0].wq).__name__ == "MXFP4Linear"
    assert tw.layers[0].moe.quant_kind == "mxfp4"
    got, want = _both(jcfg, jw, tcfg, tw, 2, 1, lambda c: _greedy(c, [1, 2, 3], 3),
                      n_lanes=1, max_seq=64)
    _hold(got, want)


def test_tp_gptoss(tmp_path):
    """gpt-oss: sinks split per head, expert biases with the F columns, the
    down bias once after the reduce."""
    export_random_gguf(JPRESETS["tiny-oss"], tmp_path / "oss.gguf", seed=23)
    jcfg, jw, tcfg, tw = _gguf_pair(tmp_path / "oss.gguf")
    got, want = _both(jcfg, jw, tcfg, tw, 2, 1, lambda c: _greedy(c, list(range(1, 20)), 3),
                      n_lanes=1, max_seq=64)
    _hold(got, want)


def test_tp_mla(tmp_path):
    """deepseek2 at tp 2 x dp 2: query heads, wk_b / wv_b and wo over tp, the
    latent projections and the one-head latent cache whole on every shard,
    through V3 grouped routing."""
    export_random_gguf(JPRESETS["tiny-mla"], tmp_path / "mla.gguf", seed=7)
    jcfg, jw, tcfg, tw = _gguf_pair(tmp_path / "mla.gguf", mesh_fuse=True)
    got, want = _both(jcfg, jw, tcfg, tw, 4, 2, lambda c: _greedy(c, [1, 5, 9, 200, 3], 3),
                      n_lanes=2, max_seq=64)
    _hold(got, want)


def test_tp_multimodal_mrope():
    """M-RoPE image rows and the trailing text under tp 2: the [B, T, 3] rows
    ride along to every shard."""
    cfg = _cfg(arch="qwen2vl", qk_norm=False, rope_sections=(32, 16, 16))
    w = jllama.random_weights(cfg, seed=11, quantize=True)
    tcfg, tw = _port(cfg, w)
    chunk = np.random.default_rng(0).standard_normal((6, cfg.n_embd)).astype(np.float32) * 0.02

    def run(ctx):
        seq = ctx.new_sequence()
        rows = [_np(ctx.prefill(seq, [3, 17, 42, 100])),
                _np(ctx.prefill_embeds(seq, chunk, mrope_grid=(2, 3))),
                _np(ctx.prefill(seq, [5, 99, 7]))]
        assert ctx.kv.mrope_delta[ctx.kv.lane_of(seq)] == -3
        dec = _np(ctx.decode({seq: int(rows[-1][-1].argmax())})[seq])
        return np.concatenate(rows, axis=0), dec

    (gr, gd), (wr, wd) = _both(cfg, w, tcfg, tw, 2, 1, run, n_lanes=2, max_seq=64)
    np.testing.assert_allclose(gr, wr, rtol=0, atol=TOL)
    np.testing.assert_array_equal(gr.argmax(-1), wr.argmax(-1))
    np.testing.assert_allclose(gd, wd, rtol=0, atol=TOL)
    assert int(gd.argmax()) == int(wd.argmax())


def test_tp_seq_div_decode():
    cfg = _cfg()
    w = jllama.random_weights(cfg, seed=13, quantize=True)
    tcfg, tw = _port(cfg, w)

    def run(ctx):
        seq = ctx.new_sequence()
        ctx.prefill(seq, [3, 1, 4, 1, 5, 9, 2, 6], all_logits=False)
        ctx.kv.seq_div(ctx.cfg, seq, 0, 1 << 30, 2)
        return _np(ctx.decode({seq: 7})[seq])

    got, want = _both(cfg, w, tcfg, tw, 8, 2, run, n_lanes=2, max_seq=64)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert int(got.argmax()) == int(want.argmax())


def test_make_context_refuses_a_mesh_for_recurrent_models():
    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.runtime.recurrent import make_context

    mesh = make_mesh(devices=["cpu"] * 2)
    for arch, extra in (("mamba", dict(ssm_d_inner=512, ssm_d_state=16, ssm_d_conv=4,
                                       ssm_dt_rank=16)),
                        ("jamba", dict(ssm_d_inner=512, ssm_d_state=16, ssm_d_conv=4,
                                       ssm_dt_rank=16))):
        cfg = ModelConfig(arch=arch, n_layers=2, n_embd=256, n_heads=0, n_kv_heads=0,
                          head_dim=0, n_ff=0, vocab_size=64, context_length=64, **extra)
        with pytest.raises(NotImplementedError, match="--tp/--dp is not yet supported"):
            make_context(cfg, None, n_lanes=1, max_seq=32, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="n_lanes=3 must be divisible by dp=2"):
        cfg = _cfg()
        InferenceContext(*_port(cfg, jllama.random_weights(cfg, seed=1, quantize=True)),
                         n_lanes=3, mesh=make_mesh(devices=["cpu"] * 4, dp=2))


# -- the CLI --------------------------------------------------------------------

@pytest.fixture(scope="module")
def tp_gguf(tmp_path_factory):
    """A 2-layer TCQ4 GGUF whose row-parallel K stays 256-aligned at tp 2,
    with a char vocabulary."""
    from rrs_tpu.quantize.quantizer import quantize_model

    d = tmp_path_factory.mktemp("torch_tp_cli")
    export_random_gguf(_cfg(), d / "f32.gguf", seed=0, vocab_tokens=tiny_vocab_tokens(512))
    quantize_model(d / "f32.gguf", d / "tcq4.gguf", verbose=False)
    return d / "tcq4.gguf"


def _generate(capsys, path, *flags):
    from rrs_tpu_torch.__main__ import main

    main(["generate", "-m", str(path), "-p", "the fox", "-n", "6", "--ctx", "64",
          "--device", "cpu", *flags])
    return capsys.readouterr().out.strip().splitlines()[-1]


def test_cli_generate_and_bench_with_tp(tp_gguf, capsys):
    from rrs_tpu_torch.__main__ import main

    plain = _generate(capsys, tp_gguf)
    assert _generate(capsys, tp_gguf, "--tp", "2") == plain
    assert _generate(capsys, tp_gguf, "--tp", "2", "--dp", "2") == plain
    main(["bench", "-m", str(tp_gguf), "--pp", "8", "--tg", "2", "-r", "1", "--batch", "2",
          "--json", "--device", "cpu", "--tp", "2", "--dp", "2"])
    rows = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert len(rows) == 2 and all(r["tensor_split"] == "tp2/dp2" for r in rows)
    assert all(r["avg_ts"] > 0 for r in rows)


def test_cli_serve_with_tp_subprocess(tp_gguf, capsys):
    """``serve --tp 2 --device cpu`` prints its mesh and answers a greedy
    completion with the text the single-device ``generate`` prints."""
    import http.client

    plain = _generate(capsys, tp_gguf, "--no-bos")
    proc = subprocess.Popen(
        [sys.executable, "-m", "rrs_tpu_torch", "serve", "-m", str(tp_gguf), "--device", "cpu",
         "--port", "0", "--parallel", "2", "--ctx", "64", "--tp", "2"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        mesh_line = proc.stdout.readline()
        assert "tensor/data parallel over mesh {'dp': 1, 'tp': 2}" in mesh_line, mesh_line
        line = proc.stdout.readline()
        port = int(line.split("http://127.0.0.1:")[1].split()[0])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": "the fox", "max_tokens": 6, "temperature": 0.0}),
                     {"Content-Type": "application/json"})
        body = json.loads(conn.getresponse().read())
        conn.close()
        assert body["choices"][0]["text"].strip() == plain
    finally:
        proc.send_signal(2)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
