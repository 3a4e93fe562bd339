"""The device-side decode run of rrs_tpu_torch (the serving fast path) on the
2-layer W4A4 model of tests/test_torch_common.py: greedy runs give the tokens
of the host decode loop and of the JAX package's greedy ``generate`` (run op
by op, ROADMAP queue C); chained runs give the tokens of one long run; and
the engine cases of tests/test_decode_run.py that need no grammar: a stop
token rewinds the lane, top_k = 1 is greedy, several slots decode together,
and penalties, logit bias and DRY on the device pick what the host chain
picks at temperature 0."""

import jax
import numpy as np
import pytest
import torch

from rrs_tpu.runtime.context import InferenceContext as JaxContext
from rrs_tpu_torch.models.llama import weights_from_numpy
from rrs_tpu_torch.runtime.context import InferenceContext
from rrs_tpu_torch.runtime.sampler import SamplerParams
from rrs_tpu_torch.serving.engine import Engine, GenRequest

from test_torch_common import small_jax_model, torch_cfg, weights_tree

PROMPT = [3, 17, 42, 99, 5, 8, 250, 1, 77, 64]


@pytest.fixture(scope="module")
def model():
    jcfg, jw = small_jax_model(seed=0)
    cfg = torch_cfg(jcfg)
    return jcfg, jw, cfg, weights_from_numpy(cfg, weights_tree(jw), device="cpu")


def _ctx(model, n_lanes=1, max_seq=96):
    return InferenceContext(model[2], model[3], n_lanes=n_lanes, max_seq=max_seq, device="cpu")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _run(eng, prompt, max_tokens, temperature=0.0, stop_tokens=(), **params):
    out, done = [], {}

    def on_token(tok, piece, finished, reason):
        if finished:
            done["r"] = reason
        elif tok is not None:
            out.append(tok)

    eng.submit(GenRequest(prompt_tokens=list(prompt), max_tokens=max_tokens,
                          params=SamplerParams(temperature=temperature, **params),
                          stop_tokens=stop_tokens, on_token=on_token))
    for _ in range(300):
        eng._iterate()
        if done:
            break
    assert done, "request did not finish"
    return out, done["r"]


def _host_engine(model, **kw):
    eng = Engine(_ctx(model, **kw))
    eng._fast_eligible = lambda s: False          # the per-token host path
    return eng


def _count_runs(eng):
    calls = {"fast": 0}
    orig = eng._dispatch_fast

    def counting(gen, chain=None):
        calls["fast"] += 1
        return orig(gen, chain)

    eng._dispatch_fast = counting
    return calls


def test_greedy_run_matches_host_loop_and_jax(model):
    n = 4
    ctx = _ctx(model)
    seq = ctx.new_sequence()
    t0 = int(ctx.prefill(seq, PROMPT)[-1].argmax())
    start = ctx.kv.lengths[0]
    toks, gens = ctx.decode_run({seq: t0}, {seq: _gen()}, {seq: SamplerParams(temperature=0.0)},
                                n)
    assert ctx.kv.lengths[0] == start + n and isinstance(gens[seq], torch.Generator)
    ctx.kv.seq_rm(seq, p0=start)
    host, tok = [], t0
    for _ in range(n):
        tok = int(ctx.decode({seq: tok})[seq].argmax())
        host.append(tok)
    assert toks[seq].tolist() == host
    jcfg, jw = model[0], model[1]
    with jax.disable_jit():
        ref = JaxContext(jcfg, jw, n_lanes=1, max_seq=64).generate(PROMPT, n + 1)
    assert [t0] + host == ref


@pytest.mark.parametrize("penalties", [False, True])
def test_chained_runs_match_one_long_run(model, penalties):
    """A run chained on the previous handle's device outputs continues it
    exactly; with penalties the eviction schedule slides the window across
    the seam (last_n = 2n)."""
    n = 6
    kw = dict(penalty_repeat=1.3, penalty_freq=0.2, penalty_present=0.1,
              penalty_last_n=2 * n) if penalties else {}
    p = SamplerParams(temperature=0.0, **kw)
    outs = []
    for chained in (True, False):
        ctx = _ctx(model)
        seq = ctx.new_sequence()
        t0 = int(ctx.prefill(seq, PROMPT)[-1].argmax())
        hist = {seq: [t0]}
        if chained:
            h1 = ctx.decode_run_start({seq: t0}, {seq: _gen()}, {seq: p}, n, histories=hist)
            h2 = ctx.decode_run_start({seq: None}, {seq: _gen()}, {seq: p}, n, chain=h1,
                                      histories=hist)
            outs.append(h1["toks"][0].tolist() + h2["toks"][0].tolist())
        else:
            h = ctx.decode_run_start({seq: t0}, {seq: _gen()}, {seq: p}, 2 * n, histories=hist)
            outs.append(h["toks"][0].tolist())
        assert ctx.kv.lengths[0] == len(PROMPT) + 2 * n
    assert outs[0] == outs[1]


def test_engine_fast_path_greedy_matches_host(model):
    eng = Engine(_ctx(model))
    calls = _count_runs(eng)
    out_fast, r = _run(eng, [5, 6, 7], 20)
    assert len(out_fast) == 20 and r == "length" and calls["fast"] >= 1
    out_host, _ = _run(_host_engine(model), [5, 6, 7], 20)
    assert out_fast == out_host


def test_stop_token_rewind(model):
    ctx = _ctx(model)
    eng = Engine(ctx)
    ref, _ = _run(eng, [5, 6, 7], 12)
    j = next((i for i in range(1, len(ref)) if ref[i] not in ref[:i]), 0)
    out, r = _run(eng, [5, 6, 7], 12, stop_tokens=(ref[j],))
    assert r == "stop" and out == ref[:j]
    # the lane keeps the fed tokens only: cache_tokens hold the prompt and
    # every generated token (the stop token too), the lane one fewer
    s = eng.slots[0]
    assert ctx.kv.lengths[ctx.kv.lane_of(s.retained_seq)] == len(s.cache_tokens) - 1


def test_sampling_top_k1_is_greedy(model):
    eng = Engine(_ctx(model, n_lanes=2))
    greedy, _ = _run(eng, [9, 8], 10)
    topk1, _ = _run(eng, [9, 8], 10, temperature=0.9, top_k=1)
    assert topk1 == greedy


def test_multi_slot_matches_single(model):
    eng = Engine(_ctx(model, n_lanes=2))
    results = {}

    def make_cb(tag):
        results[tag] = ([], {})

        def cb(tok, piece, finished, reason):
            if finished:
                results[tag][1]["r"] = reason
            elif tok is not None:
                results[tag][0].append(tok)
        return cb

    eng.submit(GenRequest(prompt_tokens=[1, 2, 3], max_tokens=12,
                          params=SamplerParams(temperature=0.0), on_token=make_cb("a")))
    eng.submit(GenRequest(prompt_tokens=[4, 5], max_tokens=9,
                          params=SamplerParams(temperature=0.0), on_token=make_cb("b")))
    for _ in range(300):
        eng._iterate()
        if all("r" in v[1] for v in results.values()):
            break
    assert len(results["a"][0]) == 12 and len(results["b"][0]) == 9
    eng2 = Engine(_ctx(model, n_lanes=2))
    a2, _ = _run(eng2, [1, 2, 3], 12)
    b2, _ = _run(eng2, [4, 5], 9)
    assert results["a"][0] == a2 and results["b"][0] == b2


def test_penalties_on_device_match_host(model):
    kw = dict(penalty_repeat=1.4, penalty_freq=0.15, penalty_present=0.2, penalty_last_n=48)
    eng = Engine(_ctx(model, max_seq=192))
    calls = _count_runs(eng)
    out_fast, r = _run(eng, [5, 6, 7], 40, **kw)
    assert len(out_fast) == 40 and r == "length" and calls["fast"] >= 1
    out_host, _ = _run(_host_engine(model, max_seq=192), [5, 6, 7], 40, **kw)
    assert out_fast == out_host
    plain, _ = _run(Engine(_ctx(model, max_seq=192)), [5, 6, 7], 40)
    assert out_fast != plain


def test_small_last_n_falls_back_to_host(model):
    kw = dict(penalty_repeat=1.4, penalty_last_n=8)
    eng = Engine(_ctx(model, max_seq=192))
    calls = _count_runs(eng)
    out, _ = _run(eng, [5, 6, 7], 24, **kw)
    assert calls["fast"] == 0
    out_h, _ = _run(_host_engine(model, max_seq=192), [5, 6, 7], 24, **kw)
    assert out == out_h


def test_logit_bias_on_device(model):
    eng = Engine(_ctx(model))
    out, _ = _run(eng, [5, 6, 7], 8, logit_bias=((42, 100.0),))
    assert out == [42] * 8
    plain, _ = _run(eng, [9, 8], 10)
    out2, _ = _run(eng, [9, 8], 10, logit_bias=((plain[0], -1e9),))
    assert plain[0] not in out2


def test_dry_on_device_matches_host(model):
    kw = dict(dry_multiplier=2.5, dry_base=1.75, dry_allowed_length=2)
    eng = Engine(_ctx(model, max_seq=160))
    calls = _count_runs(eng)
    out_fast, r = _run(eng, [5, 6, 7], 40, **kw)
    assert len(out_fast) == 40 and calls["fast"] >= 1
    out_host, _ = _run(_host_engine(model, max_seq=160), [5, 6, 7], 40, **kw)
    assert out_fast == out_host


def test_logprobs_from_run_candidates(model):
    eng = Engine(_ctx(model))
    calls = _count_runs(eng)
    probs, out, done = [], [], {}
    eng.submit(GenRequest(prompt_tokens=[5, 6, 7], max_tokens=12,
                          params=SamplerParams(temperature=0.0), n_probs=5,
                          on_token=lambda t, p, fin, r: done.update(r=r) if fin else out.append(t),
                          on_probs=lambda t, lp, top: probs.append((t, lp, top))))
    for _ in range(300):
        eng._iterate()
        if done:
            break
    assert done and len(out) == 12 and calls["fast"] >= 1 and len(probs) == 12
    for token, lp, top in probs:
        lps = [x[1] for x in top]
        assert len(top) == 5 and lps == sorted(lps, reverse=True) and lps[0] <= 1e-9
        assert token == top[0][0] and abs(lp - top[0][1]) < 1e-9
