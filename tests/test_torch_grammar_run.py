"""Grammar-constrained decoding in the port's device run and engine, on the
2-layer W4A4 model of tests/test_torch_common.py against the JAX package
(run op by op under ``jax.disable_jit()``, ROADMAP queue C):

- ``decode_run_start(dfa=...)`` at greedy gives JAX's tokens and DFA states,
  in one run and in two chained runs, and the masking changes what an
  unconstrained run picks;
- the engine's optimistic path (no DFA: free device runs, the host PDA at
  flush, resampled from the captured candidates) emits only legal tokens,
  the host path's;
- ``_resample_from_candidates`` picks JAX's token from the same candidate
  rows (greedy and seeded);
- the DFA compiles in the spawned child and reaches ``_DFA_CACHE``, equal to
  an in-process compile, and a later request's runs carry it.
Token ids are held exactly; there is no float tolerance to state."""

import string
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.runtime import grammar as jg
from rrs_tpu.runtime.context import InferenceContext as JaxContext
from rrs_tpu.runtime.sampler import SamplerParams as JaxParams
from rrs_tpu.serving.engine import Engine as JaxEngine
from rrs_tpu_torch.models.llama import weights_from_numpy
from rrs_tpu_torch.runtime import grammar as tg
from rrs_tpu_torch.runtime.context import InferenceContext
from rrs_tpu_torch.runtime.sampler import SamplerParams
from rrs_tpu_torch.serving import engine as em
from rrs_tpu_torch.serving.engine import Engine, GenRequest

from test_torch_common import small_jax_model, torch_cfg, weights_tree

PROMPT = [3, 17, 42, 99, 5, 8, 250, 1, 77, 64]
GBNF = "root ::= [a-z ]+"


@pytest.fixture(scope="module")
def model():
    jcfg, jw = small_jax_model(seed=0)
    cfg = torch_cfg(jcfg)
    return jcfg, jw, cfg, weights_from_numpy(cfg, weights_tree(jw), device="cpu")


def _free_greedy(model, n):
    """Plain greedy tokens after the prompt (the first from the prefill)."""
    ctx = InferenceContext(model[2], model[3], max_seq=96, device="cpu")
    return ctx.generate(PROMPT, n + 1)


@pytest.fixture(scope="module")
def pieces(model):
    """Lower-case word pieces, except that every token the unconstrained
    greedy run picks after the first is illegal ("<|x|>"), so the DFA must
    change the run."""
    rng = np.random.default_rng(0)
    out = ["".join(rng.choice(list(string.ascii_lowercase), int(rng.integers(1, 4)))) + " "
           for _ in range(model[2].vocab_size)]
    for t in _free_greedy(model, 6)[1:]:
        out[t] = "<|x|>"
    return out


def _dfa(mod, pieces):
    return mod.compile_token_dfa(mod.Grammar(GBNF), pieces, mod.build_token_trie(pieces))


def _torch_run(model, dfa, n_steps, chained):
    ctx = InferenceContext(model[2], model[3], max_seq=96, device="cpu")
    seq = ctx.new_sequence()
    t0 = int(ctx.prefill(seq, PROMPT)[-1].argmax())
    arg = (torch.from_numpy(dfa.masks), torch.from_numpy(dfa.trans), {seq: 0})
    gen, p = {seq: torch.Generator().manual_seed(0)}, {seq: SamplerParams(temperature=0.0)}
    if not chained:
        h = ctx.decode_run_start({seq: t0}, gen, p, n_steps, dfa=arg)
        return t0, h["toks"][0].tolist(), int(h["gstate"][0])
    h1 = ctx.decode_run_start({seq: t0}, gen, p, n_steps // 2, dfa=arg)
    h2 = ctx.decode_run_start({seq: None}, gen, p, n_steps - n_steps // 2, chain=h1)
    return t0, h1["toks"][0].tolist() + h2["toks"][0].tolist(), int(h2["gstate"][0])


def _jax_run(model, dfa, n_steps, chained):
    with jax.disable_jit():
        ctx = JaxContext(model[0], model[1], n_lanes=1, max_seq=96)
        seq = ctx.new_sequence()
        t0 = int(np.argmax(np.asarray(ctx.prefill(seq, PROMPT)[-1])))
        arg = (jnp.asarray(dfa.masks), jnp.asarray(dfa.trans), {seq: 0})
        key, p = {seq: jax.random.PRNGKey(0)}, {seq: JaxParams(temperature=0.0)}
        if not chained:
            h = ctx.decode_run_start({seq: t0}, key, p, n_steps, dfa=arg)
            return t0, np.asarray(h["toks"])[0].tolist(), int(np.asarray(h["gstate"])[0])
        h1 = ctx.decode_run_start({seq: t0}, key, p, n_steps // 2, dfa=arg)
        h2 = ctx.decode_run_start({seq: None}, key, p, n_steps - n_steps // 2, chain=h1)
        return (t0, np.asarray(h1["toks"])[0].tolist() + np.asarray(h2["toks"])[0].tolist(),
                int(np.asarray(h2["gstate"])[0]))


@pytest.mark.parametrize("chained", [False, True], ids=["one run", "chained"])
def test_dfa_decode_run_matches_jax(model, pieces, chained):
    n = 4
    dfa = _dfa(tg, pieces)
    assert dfa is not None and dfa.masks.shape[0] <= 4
    t0, got, gstate = _torch_run(model, dfa, n, chained)
    assert (t0, got, gstate) == _jax_run(model, _dfa(jg, pieces), n, chained)
    assert all(pieces[t] != "<|x|>" for t in got)
    assert got != _free_greedy(model, n)[1:], "the DFA did not change the run"
    # the lane's state followed the host DFA's walk through trans
    walk = 0
    for t in got:
        walk = int(dfa.trans[walk, t])
    assert gstate == walk


def _drive(eng, pieces, trie, max_tokens=12, temperature=0.0):
    out, done = [], {}

    def on_token(tok, piece, finished, reason):
        if finished:
            done["r"] = reason
        elif tok is not None:
            out.append(tok)

    eng.submit(GenRequest(prompt_tokens=list(PROMPT), max_tokens=max_tokens,
                          params=SamplerParams(temperature=temperature),
                          grammar=tg.Grammar(GBNF), token_pieces=pieces, token_trie=trie,
                          on_token=on_token))
    for _ in range(500):
        eng._iterate()
        if done:
            break
    assert done, "request did not finish"
    return out


def test_optimistic_path_gives_legal_tokens(model, pieces):
    """Without a token trie no DFA is compiled: the device runs sample freely
    and the host PDA validates at flush. The greedy tokens are legal, equal
    to the per-token host path's, and the free picks were resampled."""
    ctx = InferenceContext(model[2], model[3], max_seq=96, device="cpu")
    ctx.DECODE_RUN_STEPS = 4
    eng = Engine(ctx)
    got = _drive(eng, pieces, trie=None)
    assert eng.n_decode_runs >= 1 and eng.n_dfa_runs == 0 and eng.n_resampled >= 1
    assert all(pieces[t] != "<|x|>" for t in got)
    g = tg.Grammar(GBNF)
    assert g.accept_text("".join(pieces[t] for t in got))
    host = Engine(InferenceContext(model[2], model[3], max_seq=96, device="cpu"))
    host._fast_eligible = lambda s: False
    assert _drive(host, pieces, trie=None) == got


def _cand_slot(mod, pieces, temperature, prefix):
    g = mod.Grammar('root ::= "{" [a-z]+ "}"')
    g.accept_text(prefix)
    params = (JaxParams if mod is jg else SamplerParams)(temperature=temperature, top_k=40,
                                                         top_p=0.95, min_p=0.05)
    req = types.SimpleNamespace(token_pieces=pieces, params=params, stop_tokens=(1,))
    return types.SimpleNamespace(grammar=g, req=req)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resample_from_candidates_matches_jax(seed, temperature):
    rng = np.random.default_rng(seed)
    pieces = ["{", '"', "}"] + ["".join(rng.choice(list("abc}{1"), int(rng.integers(1, 3))))
                                for _ in range(253)]
    ids = rng.permutation(256)[:128]
    vals = np.sort(rng.standard_normal(128).astype(np.float32))[::-1] * 3
    prefix = "{" if seed != 2 else "{ab"
    picks = []
    for mod, eng in ((tg, Engine), (jg, JaxEngine)):
        slot = _cand_slot(mod, pieces, temperature, prefix)
        picks.append(eng._resample_from_candidates(None, slot, vals, ids, seed=1234 + seed))
    assert picks[0] == picks[1] and picks[0] is not None


def test_resample_past_top_k_stays_legal():
    """When every legal candidate ranks past top-k, a sampled resample draws
    among the legal ones. JAX's draws over the top-k-filtered logits, in
    which they are all -inf, and so returns the top candidate, illegal
    (ROADMAP queue C); at temperature 0 both pick the best legal one."""
    pieces = ["<x>"] * 60 + ["a", "b", "c"] + ["<x>"] * 193
    ids = np.arange(128)
    vals = np.linspace(5.0, -5.0, 128).astype(np.float32)
    picks = {}
    for temperature in (0.0, 0.8):
        for mod, eng in ((tg, Engine), (jg, JaxEngine)):
            slot = _cand_slot(mod, pieces, temperature, "{")
            slot.grammar = mod.Grammar("root ::= [a-z]+")
            picks[temperature, mod.__name__] = eng._resample_from_candidates(
                None, slot, vals, ids, seed=7)
    assert picks[0.0, tg.__name__] == picks[0.0, jg.__name__] == 60
    assert picks[0.8, tg.__name__] in (60, 61, 62)
    assert pieces[picks[0.8, jg.__name__]] == "<x>"


def test_dfa_compiles_in_the_spawned_child(model, pieces):
    """The engine's launch starts the compile in a spawned process; the DFA
    lands in _DFA_CACHE equal to an in-process compile, and the next
    request's runs carry it, chained, with no resample and the tokens of
    the first request (which ran before the DFA was ready)."""
    trie = tg.build_token_trie(pieces)
    ctx = InferenceContext(model[2], model[3], max_seq=96, device="cpu")
    ctx.DECODE_RUN_STEPS = 4
    eng = Engine(ctx)
    key = (GBNF, len(pieces))
    with em._DFA_LOCK:
        em._DFA_CACHE.pop(key, None)
    first = _drive(eng, pieces, trie)
    for _ in range(1200):
        with em._DFA_LOCK:
            if key in em._DFA_CACHE:
                break
        time.sleep(0.05)
    with em._DFA_LOCK:
        dfa = em._DFA_CACHE.get(key)
    assert dfa is not None, "the spawned DFA compile failed"
    ref = _dfa(tg, pieces)
    np.testing.assert_array_equal(dfa.masks, ref.masks)
    np.testing.assert_array_equal(dfa.trans, ref.trans)
    assert em.DFA_COMPILE_S[key] > 0
    chains = {"n": 0}
    orig = eng._dispatch_fast

    def counting(gen, chain=None):
        chains["n"] += chain is not None
        return orig(gen, chain)

    eng._dispatch_fast = counting
    runs0 = eng.n_dfa_runs
    resampled0 = eng.n_resampled
    again = _drive(eng, pieces, trie)
    assert eng.n_dfa_runs > runs0 and chains["n"] > 0
    assert eng.n_resampled == resampled0
    assert again == first
