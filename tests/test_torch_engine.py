"""The serving engine of rrs_tpu_torch: prompt-cache reuse and batched
prompts (the cases of tests/test_engine_cache.py), the same greedy tokens as
rrs_tpu's engine for two concurrent requests, and the context shift, both at
the KV level against rrs_tpu's ``seq_shift`` and through a request that runs
past the context. CPU tests pass ``device="cpu"``: the engine's default is
the card."""

import jax
import numpy as np
import pytest
import torch

from rrs_tpu.models.config import PRESETS as JAX_PRESETS
from rrs_tpu.models.llama import random_weights as jax_random_weights
from rrs_tpu.runtime.context import InferenceContext as JaxContext
from rrs_tpu.runtime.kv_cache import KVCache as JaxKVCache
from rrs_tpu.runtime.sampler import SamplerParams as JaxParams
from rrs_tpu.serving.engine import Engine as JaxEngine
from rrs_tpu.serving.engine import GenRequest as JaxRequest
from rrs_tpu_torch.models.config import PRESETS
from rrs_tpu_torch.models.llama import random_weights, weights_from_numpy
from rrs_tpu_torch.runtime.context import InferenceContext
from rrs_tpu_torch.runtime.kv_cache import KVCache
from rrs_tpu_torch.runtime.sampler import SamplerParams
from rrs_tpu_torch.serving.engine import Engine, GenRequest, SlotState

from test_torch_common import jax_cfg, torch_cfg, weights_tree

CFG = PRESETS["tiny"]


def _engine(w, n_lanes=1, max_seq=64):
    return Engine(InferenceContext(CFG, w, n_lanes=n_lanes, max_seq=max_seq, device="cpu"))


def _run(eng, prompt, max_tokens=3):
    out, done = [], {}

    def on_token(tok, piece, finished, reason):
        if finished:
            done["r"] = reason
        elif tok is not None:
            out.append(tok)

    eng.submit(GenRequest(prompt_tokens=list(prompt), max_tokens=max_tokens,
                          params=SamplerParams(temperature=0.0), on_token=on_token))
    for _ in range(400):
        eng._iterate()
        if done:
            break
    assert done, "request did not finish"
    return out, done["r"]


def test_multi_turn_reuse_matches_fresh():
    w = random_weights(CFG, seed=0, device="cpu")
    eng_a = _engine(w)
    turn1 = [5, 6, 7, 8, 9]
    gen1, _ = _run(eng_a, turn1)
    slot = eng_a.slots[0]
    kv = eng_a.ctx.kv
    stored = kv.lengths[kv.lane_of(slot.retained_seq)]
    # the cached token list holds one more token than the lane (the final
    # sampled token is never fed)
    assert len(slot.cache_tokens) == stored + 1
    turn2 = turn1 + gen1 + [11, 12]
    gen2, _ = _run(eng_a, turn2)
    assert 0 < slot.n_reused <= stored
    gen2_fresh, _ = _run(_engine(w), turn2)
    assert gen2 == gen2_fresh


def test_batched_prompt_matches_sequential():
    w = random_weights(CFG, seed=3, device="cpu")
    prompts = {0: [5, 6, 7, 8], 1: [9, 10], 2: [11, 12, 13, 14, 15, 16, 17]}
    eng1 = _engine(w, max_seq=96)
    ref = {rid: _run(eng1, p, max_tokens=4)[0] for rid, p in prompts.items()}
    eng = _engine(w, n_lanes=4, max_seq=96)
    outs = {rid: [] for rid in prompts}
    done = {}
    for rid, p in prompts.items():
        eng.submit(GenRequest(
            prompt_tokens=list(p), max_tokens=4, params=SamplerParams(temperature=0.0),
            on_token=lambda t, pc, fin, r, rid=rid: done.__setitem__(rid, r) if fin
            else outs[rid].append(t)))
    for _ in range(400):
        eng._iterate()
        if len(done) == len(prompts):
            break
    assert outs == ref


def test_concurrent_greedy_matches_jax_engine():
    """Two concurrent greedy requests through both packages' engines, each
    driven by _iterate() in this thread (the JAX one op by op): batched
    prefill, then device decode runs of 8 steps, identical tokens. The
    weights are the tiny preset's dense ones at scale 0.3, so that greedy
    decoding does not settle on one token."""
    jw = jax_random_weights(JAX_PRESETS["tiny"], seed=0, scale=0.3)
    tw = weights_from_numpy(CFG, weights_tree(jw), device="cpu")
    prompts = {0: [5, 6, 7, 8], 1: [9, 10]}

    def drive(eng, request, params):
        outs, done = {rid: [] for rid in prompts}, {}
        for rid, p in prompts.items():
            eng.submit(request(prompt_tokens=p, max_tokens=10, params=params(temperature=0.0),
                               on_token=lambda t, pc, f, r, rid=rid:
                               done.__setitem__(rid, r) if f else outs[rid].append(t)))
        for _ in range(200):
            eng._iterate()
            if len(done) == len(prompts):
                break
        assert done == {0: "length", 1: "length"}
        return outs

    jctx = JaxContext(JAX_PRESETS["tiny"], jw, n_lanes=2, max_seq=96)
    jctx.DECODE_RUN_STEPS = 8
    with jax.disable_jit():
        ref = drive(JaxEngine(jctx), JaxRequest, JaxParams)
    tctx = InferenceContext(CFG, tw, n_lanes=2, max_seq=96, device="cpu")
    tctx.DECODE_RUN_STEPS = 8
    eng = Engine(tctx)
    got = drive(eng, GenRequest, SamplerParams)
    assert got == ref
    assert eng.n_decode_runs >= 1 and len(set(got[0])) > 1


def test_seq_shift_matches_jax():
    """Drop cells [1, 1 + 9), slide the tail down and rotate the moved K by
    -9 positions: the same bf16 lane as the JAX package's (one bf16 ulp
    where the two round the rotation's f32 result to either side)."""
    jcfg = jax_cfg(n_layers=2)
    cfg = torch_cfg(jcfg)
    rng = np.random.default_rng(0)
    jkv = JaxKVCache.create(jcfg, n_lanes=2, max_seq=32)
    tkv = KVCache.create(cfg, n_lanes=2, max_seq=32)
    shape = tuple(tkv.k[0].shape)
    before = {}
    for li in range(cfg.n_layers):
        for name in ("k", "v"):
            a = rng.standard_normal(shape).astype(np.float32)
            getattr(tkv, name)[li] = torch.from_numpy(a).to(torch.bfloat16)
            getattr(jkv, name)[li] = jax.numpy.asarray(a, jax.numpy.bfloat16)
            before[name, li] = getattr(tkv, name)[li].float().numpy()
    for kv in (jkv, tkv):
        kv.seq_new(7)
        kv.seq_new(8)
        kv.lengths[1] = 30
    jkv.seq_shift(jcfg, 8, 1, 9)
    tkv.seq_shift(cfg, 8, 1, 9)
    assert tkv.lengths == jkv.lengths == [0, 21]
    for li in range(cfg.n_layers):
        for name in ("k", "v"):
            got = getattr(tkv, name)[li].float().numpy()
            ref = np.asarray(getattr(jkv, name)[li], np.float32)
            np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=1e-6)
    # V slides without rotation; cell 0 and the other lane stay as they were
    v = tkv.v[0].float().numpy()
    np.testing.assert_array_equal(v[1, :, 1:21], before["v", 0][1, :, 10:30])
    np.testing.assert_array_equal(v[1, :, 0], before["v", 0][1, :, 0])
    np.testing.assert_array_equal(tkv.k[1][0].float().numpy(), before["k", 1][0])


def test_context_shift_keeps_generating():
    """A request that runs past max_seq: the engine halves the lane when it
    reaches max_seq - 1 and the request still gets all its tokens."""
    w = random_weights(CFG, seed=1, device="cpu", scale=0.3)
    eng = _engine(w, max_seq=40)
    shifts = []
    orig = eng.ctx.kv.seq_shift
    eng.ctx.kv.seq_shift = lambda *a: shifts.append(a[2:]) or orig(*a)
    out, r = _run(eng, [5, 6, 7, 8, 9], max_tokens=60)
    assert r == "length" and len(out) == 60
    assert shifts and all(n_keep == 1 for n_keep, _ in shifts)
    kv = eng.ctx.kv
    assert kv.lengths[kv.lane_of(eng.slots[0].retained_seq)] < 40


def test_prefill_logprobs_matches_jax():
    """log p(target | prefix) with the log-softmax and gather on the device:
    the port's own prefill logits give the same values, and the JAX
    package's op by op agrees within the bf16 activation rounding of the two
    forwards (|logprob| here is ~6)."""
    jw = jax_random_weights(JAX_PRESETS["tiny"], seed=2, scale=0.3)
    tw = weights_from_numpy(CFG, weights_tree(jw), device="cpu")
    toks = [5, 9, 200, 31, 7, 7, 301, 42, 11, 3]
    tgts = toks[1:] + [0]
    ctx = InferenceContext(CFG, tw, n_lanes=2, max_seq=64, device="cpu")
    got = ctx.prefill_logprobs(ctx.new_sequence(), toks, tgts)
    assert got.dtype == np.float64 and got.shape == (len(toks),)
    assert ctx.kv.lengths[0] == len(toks)
    ctx2 = InferenceContext(CFG, tw, n_lanes=2, max_seq=64, device="cpu")
    logits = ctx2.prefill(ctx2.new_sequence(), toks)
    own = torch.log_softmax(logits, -1)[torch.arange(len(toks)), torch.tensor(tgts)]
    np.testing.assert_allclose(got, own.double().numpy(), rtol=0, atol=1e-5)
    jctx = JaxContext(JAX_PRESETS["tiny"], jw, n_lanes=2, max_seq=64)
    with jax.disable_jit():
        ref = jctx.prefill_logprobs(jctx.new_sequence(), toks, tgts)
    np.testing.assert_allclose(got, ref, rtol=0, atol=0.05)


def test_later_slices_raise():
    """Multimodal segments, which raised naming ROADMAP A11, are served: a
    [tokens, embeddings, tokens] request prefills one segment a step, counts
    the embedding rows as prompt, gets its tokens and frees its lane rather
    than keeping it as a prompt cache (the lane's agreement with JAX's engine
    is held in tests/test_torch_mtmd.py). Grammar, infill and a draft model,
    which once raised naming A6 / A13, are taken: each request is served (a
    grammar one with only legal tokens, infill through the infill sampler)
    and a draft context is kept. Slot save and restore refuse only a slot
    with nothing to save or a busy slot."""
    from rrs_tpu_torch.runtime.grammar import Grammar

    ctx = InferenceContext(CFG, random_weights(CFG, seed=0, device="cpu"), max_seq=32,
                           device="cpu")
    eng = Engine(ctx)
    emb = torch.randn((5, CFG.n_embd), generator=torch.Generator().manual_seed(0)) * 0.02
    seg_out, seg_done = [], {}
    eng.submit(GenRequest(prompt_tokens=[], max_tokens=3, segments=[
        ("tokens", [1, 2]), ("embeds", emb), ("tokens", [3])],
        on_token=lambda t, pc, f, r: seg_done.__setitem__("r", r) if f else seg_out.append(t)))
    for _ in range(20):
        eng._iterate()
        if seg_done:
            break
    assert seg_done["r"] == "length" and len(seg_out) == 3
    assert eng.n_prompt_tokens == 8 and eng.slots[0].retained_seq < 0
    assert all(s is None for s in ctx.kv.seq_ids)
    with pytest.raises(ValueError, match="no sequence to save"):
        eng.save_slot(0, "slot.bin")
    eng.slots[0].state = SlotState.PROMPT
    with pytest.raises(ValueError, match="busy"):
        eng.restore_slot(0, "slot.bin")
    eng = Engine(ctx)
    pieces = [chr(97 + i % 26) if i % 3 else "!" for i in range(CFG.vocab_size)]
    for kw in (dict(grammar=Grammar("root ::= [a-z]+"), token_pieces=pieces),
               dict(infill=True, token_pieces=pieces)):
        out, done = [], {}
        eng.submit(GenRequest(prompt_tokens=[1, 2], max_tokens=3,
                              on_token=lambda t, pc, f, r, out=out, done=done:
                              done.__setitem__("r", r) if f else out.append(t), **kw))
        for _ in range(100):
            eng._iterate()
            if done:
                break
        assert done and len(out) >= 1
        if "grammar" in kw:
            assert all(pieces[t] != "!" for t in out)
    spec = Engine(ctx, draft_ctx=ctx, n_draft=2)
    assert spec.draft_ctx is ctx and spec.n_draft == 2
