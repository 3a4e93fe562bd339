"""Speculative and prompt-lookup decoding of the port
(``rrs_tpu_torch/runtime/{speculative,lookup}.py``) against the JAX package
on the 2-layer size of tests/test_torch_common.py, with dense weights at
scale 0.3 (so that greedy text varies; the JAX side runs op by op under
``jax.disable_jit()``): a self-draft and a different draft give plain
greedy's tokens and JAX's drafted / accepted counts, as does prompt lookup
on a repetitive prompt; ``speculative_are_compatible`` agrees with JAX on
the cases of tests/test_speculative.py; an ``NGramCache`` file written by
either package loads in the other to the same drafts. Tokens and counts
are held exactly."""

import dataclasses

import jax
import pytest

from rrs_tpu.models.llama import random_weights as jax_random_weights
from rrs_tpu.models.vocab import Vocab as JaxVocab
from rrs_tpu.runtime import lookup as jlookup
from rrs_tpu.runtime import speculative as jspec
from rrs_tpu.runtime.context import InferenceContext as JaxContext
from rrs_tpu_torch.models.llama import weights_from_numpy
from rrs_tpu_torch.models.vocab import Vocab
from rrs_tpu_torch.runtime import lookup as tlookup
from rrs_tpu_torch.runtime import speculative as tspec
from rrs_tpu_torch.runtime.context import InferenceContext

from test_torch_common import jax_cfg, torch_cfg, weights_tree

N_NEW = 10


@pytest.fixture(scope="module")
def models():
    """Two dense 2-layer models (target seed 0, draft seed 1) in both
    packages."""
    jcfg = jax_cfg()
    cfg = torch_cfg(jcfg)
    out = []
    for seed in (0, 1):
        jw = jax_random_weights(jcfg, seed=seed, scale=0.3)
        out.append((jw, weights_from_numpy(cfg, weights_tree(jw), device="cpu")))
    return jcfg, cfg, out


def _tctx(models, i):
    return InferenceContext(models[1], models[2][i][1], max_seq=96, device="cpu")


def _jctx(models, i):
    return JaxContext(models[0], models[2][i][0], n_lanes=1, max_seq=96)


@pytest.mark.parametrize("draft", [0, 1], ids=["self-draft", "other draft"])
def test_generate_speculative_matches_greedy_and_jax(models, draft):
    prompt = [5, 6, 7, 8, 9]
    plain = _tctx(models, 0).generate(prompt, N_NEW)
    got, stats = tspec.generate_speculative(_tctx(models, 0), _tctx(models, draft), prompt,
                                            N_NEW, n_draft=3)
    assert got == plain and len(set(plain)) > 1
    with jax.disable_jit():
        ref, jstats = jspec.generate_speculative(_jctx(models, 0), _jctx(models, draft),
                                                 prompt, N_NEW, n_draft=3)
    assert got == ref
    if draft == 1:
        # an unrelated draft has no round with every draft accepted
        assert (stats.n_drafted, stats.n_accepted) == (jstats.n_drafted, jstats.n_accepted)
    else:
        # the dense model's decode step and verify chunk give the same
        # logits, so a self-draft is accepted whole. JAX's draft falls one
        # token behind after each fully accepted round and is rejected
        # after it (ROADMAP queue C); the port feeds the draft that token
        assert stats.n_drafted > 0 and stats.acceptance_rate == 1.0
        assert jstats.acceptance_rate < 1.0


def test_generate_lookup_matches_greedy_and_jax(models):
    prompt = [5, 6, 7, 8] * 4
    plain = _tctx(models, 0).generate(prompt, N_NEW)
    got, stats = tlookup.generate_lookup(_tctx(models, 0), prompt, N_NEW)
    assert got == plain
    with jax.disable_jit():
        ref, jstats = jlookup.generate_lookup(_jctx(models, 0), prompt, N_NEW)
    assert got == ref
    assert (stats.n_drafted, stats.n_accepted) == (jstats.n_drafted, jstats.n_accepted)
    assert stats.n_drafted > 0


def _byte_vocab(cls, n_extra=0, special_suffix=""):
    """The byte-level SPM vocabulary of tests/test_speculative.py."""
    tokens = ["<unk>", "<s>", "</s>"] + [chr(i) for i in range(256)]
    tokens += [f"<extra{i}{special_suffix}>" for i in range(n_extra)]
    return cls(model="llama", tokens=tokens, scores=[0.0] * len(tokens), token_types=None,
               merges=None, bos_id=1, eos_id=2, unk_id=0, add_bos=False,
               add_space_prefix=False)


def _pairs(cls, max_diff):
    a = _byte_vocab(cls)
    b = _byte_vocab(cls)
    b.tokens[40] = "DIFFERENT"
    return {"identical": (a, _byte_vocab(cls)),
            "tail extended": (a, _byte_vocab(cls, n_extra=4)),
            "too large a difference": (a, _byte_vocab(cls, n_extra=max_diff + 1)),
            "token text differs": (a, b),
            "eos differs": (a, dataclasses.replace(a, eos_id=0)),
            "add_bos differs": (a, dataclasses.replace(a, add_bos=True)),
            "special spelling differs": (_byte_vocab(cls, n_extra=2),
                                         _byte_vocab(cls, n_extra=2, special_suffix="_dft"))}


@pytest.mark.parametrize("case", list(_pairs(Vocab, 128)))
def test_speculative_are_compatible_as_jax(case):
    assert tspec.SPEC_VOCAB_MAX_SIZE_DIFFERENCE == jspec.SPEC_VOCAB_MAX_SIZE_DIFFERENCE
    got = tspec.speculative_are_compatible(
        *_pairs(Vocab, tspec.SPEC_VOCAB_MAX_SIZE_DIFFERENCE)[case])
    ref = jspec.speculative_are_compatible(
        *_pairs(JaxVocab, jspec.SPEC_VOCAB_MAX_SIZE_DIFFERENCE)[case])
    assert got == ref


def test_translator_round_trips_as_jax():
    """The token translator of a near-matching pair: the same ids both ways."""
    tr = tspec.VocabTranslator(_byte_vocab(Vocab, 2), _byte_vocab(Vocab, 2, "_dft"),
                               {"<extra0>": "<extra0_dft>"})
    jr = jspec.VocabTranslator(_byte_vocab(JaxVocab, 2), _byte_vocab(JaxVocab, 2, "_dft"),
                               {"<extra0>": "<extra0_dft>"})
    ids = [ord(c) + 3 for c in "hello"] + [259] + [ord("x") + 3]
    there = tr.tgt_to_dft(ids)
    assert there == jr.tgt_to_dft(ids)
    assert tr.dft_to_tgt(there) == jr.dft_to_tgt(there)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ngram_cache_file_moves_between_packages(tmp_path, writer):
    history = [1, 2, 3, 4, 1, 2, 3, 5, 1, 2, 3, 7, 8, 7, 8, 7]
    src, dst = (tlookup, jlookup) if writer == "port" else (jlookup, tlookup)
    c = src.NGramCache()
    c.update(history)
    path = tmp_path / "ngrams.json"
    c.save(path)
    loaded = dst.NGramCache.load(path)
    loaded._history = list(history)
    assert loaded.draft(4) == c.draft(4) and len(c.draft(4)) > 0
    assert {n: {k: dict(v) for k, v in m.items()} for n, m in loaded.maps.items()} == \
        {n: {k: dict(v) for k, v in m.items()} for n, m in c.maps.items()}


def _engine_run(eng, request_cls, params_cls, prompts, max_tokens):
    outs, done = {i: [] for i in range(len(prompts))}, {}
    for i, p in enumerate(prompts):
        eng.submit(request_cls(prompt_tokens=list(p), max_tokens=max_tokens[i],
                               params=params_cls(temperature=0.0),
                               on_token=lambda t, pc, f, r, i=i:
                               done.__setitem__(i, r) if f else outs[i].append(t)))
    for _ in range(400):
        eng._iterate()
        if len(done) == len(prompts):
            break
    assert len(done) == len(prompts)
    return outs


@pytest.mark.parametrize("n_requests", [1, 2])
def test_engine_with_draft_matches_jax(models, n_requests):
    """Server-side speculative decoding: a lone greedy slot drafts and
    verifies (two slots decode one token a step until the shorter request
    finishes, then the other drafts); the tokens are plain greedy's, and
    tokens and counts are JAX's engine's."""
    from rrs_tpu.runtime.sampler import SamplerParams as JaxParams
    from rrs_tpu.serving.engine import Engine as JaxEngine
    from rrs_tpu.serving.engine import GenRequest as JaxRequest
    from rrs_tpu_torch.runtime.sampler import SamplerParams
    from rrs_tpu_torch.serving.engine import Engine, GenRequest

    prompts = [[5, 6, 7, 8, 9], [11, 12, 13]][:n_requests]
    max_tokens = [12, 4][:n_requests]
    jcfg, cfg = models[0], models[1]
    lanes = dict(n_lanes=2, max_seq=96)
    eng = Engine(InferenceContext(cfg, models[2][0][1], device="cpu", **lanes),
                 draft_ctx=InferenceContext(cfg, models[2][0][1], device="cpu", **lanes),
                 n_draft=3)
    got = _engine_run(eng, GenRequest, SamplerParams, prompts, max_tokens)
    assert eng.n_drafted > 0 and eng.n_draft_accepted > 0
    for i, p in enumerate(prompts):
        assert got[i] == _tctx(models, 0).generate(p, max_tokens[i])
    with jax.disable_jit():
        jeng = JaxEngine(JaxContext(jcfg, models[2][0][0], **lanes),
                         draft_ctx=JaxContext(jcfg, models[2][0][0], **lanes), n_draft=3)
        ref = _engine_run(jeng, JaxRequest, JaxParams, prompts, max_tokens)
    assert got == ref
    assert (eng.n_drafted, eng.n_draft_accepted) == (jeng.n_drafted, jeng.n_draft_accepted)


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    """A dense F32 2-layer GGUF (char vocabulary, scale 0.3). Dense, because
    a W4A4 model's verify chunk (B4's dequant path) and its decode step
    (B1's integer path) round apart, so speculation on it need not give
    plain decode's tokens (ROADMAP queue C)."""
    from rrs_tpu.models.export import export_random_gguf

    path = tmp_path_factory.mktemp("torch_spec") / "f32.gguf"
    vocab = [chr(33 + i) if 33 + i < 288 else f"<t{i}>" for i in range(256)]
    export_random_gguf(jax_cfg(), path, seed=0, scale=0.3, vocab_tokens=vocab)
    return path


@pytest.mark.parametrize("flags,label", [(["--lookup"], "lookup:"),
                                         (["--model-draft", None, "--draft", "3"],
                                          "speculative:")], ids=["lookup", "model-draft"])
def test_cli_generate_speculative(gguf, capsys, flags, label):
    """``generate --lookup`` and ``generate --model-draft`` print plain
    greedy's text and their drafted / accepted counts."""
    from rrs_tpu_torch.__main__ import main

    base = ["generate", "-m", str(gguf), "-p", "abcabcabcabc", "-n", "8", "--device", "cpu",
            "--ctx", "96"]
    main(base)
    plain = capsys.readouterr().out
    main(base + [str(gguf) if f is None else f for f in flags])
    out = capsys.readouterr()
    assert out.out == plain and label in out.err and "drafts accepted" in out.err


def test_cli_serve_draft_and_models_subprocess(gguf):
    """``serve --model-draft F --models second=F --device cpu``: a greedy
    completion on the default model (speculative), one routed to the second
    by name, both plain greedy's text for the file."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    from test_torch_server import _req

    root = Path(__file__).resolve().parent.parent
    proc = subprocess.Popen(
        [sys.executable, "-m", "rrs_tpu_torch", "serve", "-m", str(gguf), "--device", "cpu",
         "--port", "0", "--parallel", "1", "--ctx", "128", "--model-draft", str(gguf),
         "--draft", "3", "--models", f"second={gguf}"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        lines = [proc.stdout.readline(), proc.stdout.readline()]
        assert "speculative decoding with draft" in lines[0], lines
        assert "serving" in lines[1], (lines, proc.stderr.read() if proc.poll() else "")
        port = int(lines[1].split("http://127.0.0.1:")[1].split()[0])
        texts = []
        for extra in ({}, {"model": "second"}):
            status, data = _req(port, "POST", "/v1/completions",
                                {"prompt": "the fox", "max_tokens": 6, "temperature": 0.0,
                                 **extra})
            assert status == 200, data
            texts.append(json.loads(data)["choices"][0]["text"])
        assert texts[0] == texts[1]
        models = {m["id"]: m["loaded"] for m in json.loads(_req(port, "GET",
                                                                "/v1/models")[1])["data"]}
        assert models["second"] is True
    finally:
        proc.send_signal(2)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
