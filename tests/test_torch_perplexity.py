"""The port's quality evaluators against rrs_tpu on the CPU: perplexity
(the device log-prob branch and the host float64 branch), KL divergence and
multiple-choice scoring on the tiny GGUFs, the ``perplexity`` verb, and the
dataset loaders on the fixtures of tests/test_task_loaders.py.

Limits: the port's logits stay within LOGIT_ATOL = 0.05 of the JAX CPU
forward (tests/test_torch_model.py). A log-prob is a logit minus a
log-sum-exp, and the log-sum-exp moves by at most the largest logit move, so
each token's log-prob moves by at most 2 * LOGIT_ATOL; so does the mean NLL,
and the log of a perplexity, and a choice's summed score by that times its
token count. KL(p || q) <= max |log p - log q| <= 2 * LOGIT_ATOL. The JAX
side runs op by op under ``jax.disable_jit`` and loads through its NumPy
decode (tests/test_torch_context.py says why)."""

import json
import math
import struct
from unittest import mock

import jax
import numpy as np
import pytest

from rrs_tpu import native as jax_native
from rrs_tpu.models import loader as jax_loader
from rrs_tpu.models.export import export_random_gguf
from rrs_tpu.models.vocab import Vocab as JaxVocab
from rrs_tpu.runtime.context import InferenceContext as JaxContext
from rrs_tpu.tools import perplexity as jppl
from rrs_tpu_torch.__main__ import main
from rrs_tpu_torch.models.loader import load_model
from rrs_tpu_torch.models.vocab import Vocab
from rrs_tpu_torch.runtime.context import InferenceContext
from rrs_tpu_torch.tools import perplexity as tppl

from test_torch_common import jax_cfg, tcq4_gguf

LOGIT_ATOL = 0.05                     # tests/test_torch_model.py
LP_ATOL = 2 * LOGIT_ATOL              # one token's log-prob
N_CTX = 64
TEXT = "the quick brown fox jumps over the lazy dog; " * 4


def _jax_load(path):
    with mock.patch.object(jax_native, "available", lambda: False):
        return jax_loader.load_model(path)


@pytest.fixture(scope="module")
def tcq4(tmp_path_factory):
    """The TCQ4 tiny GGUF through both packages: (path, tokens, JAX context,
    port context)."""
    path = tcq4_gguf(tmp_path_factory.mktemp("torch_ppl"))
    jcfg, jw, md = _jax_load(path)
    tokens = JaxVocab.from_gguf(md).encode(TEXT, add_special=False)
    cfg, w, tmd = load_model(path, device="cpu")
    assert Vocab.from_gguf(tmd).encode(TEXT, add_special=False) == tokens
    return (path, tokens, JaxContext(jcfg, jw, n_lanes=1, max_seq=N_CTX),
            InferenceContext(cfg, w, n_lanes=1, max_seq=N_CTX, device="cpu"))


@pytest.mark.parametrize("device_nll", [True, False])
def test_compute_perplexity_matches_jax(tcq4, device_nll):
    _, tokens, jctx, tctx = tcq4
    assert len(tokens) >= 2 * N_CTX
    with jax.disable_jit():
        ref = jppl.compute_perplexity(jctx, tokens, n_ctx=N_CTX, device_nll=device_nll)
    got = tppl.compute_perplexity(tctx, tokens, n_ctx=N_CTX, device_nll=device_nll)
    assert got.n_tokens == ref.n_tokens == 2 * (N_CTX - 1 - N_CTX // 2)
    assert len(got.per_chunk) == len(ref.per_chunk) == 2
    assert abs(math.log(got.ppl) - math.log(ref.ppl)) <= LP_ATOL
    assert abs(got.nll_sum - ref.nll_sum) <= LP_ATOL * ref.n_tokens
    for a, b in zip(got.per_chunk, ref.per_chunk):
        assert abs(math.log(a) - math.log(b)) <= LP_ATOL


def test_perplexity_branches_agree(tcq4):
    """The device branch (f32 log-softmax on the device) and the host branch
    (f64 on the host) read the same logits: they differ by f32 rounding of a
    256-term log-sum-exp, far below 1e-5 a token."""
    _, tokens, _, tctx = tcq4
    dev = tppl.compute_perplexity(tctx, tokens, n_ctx=N_CTX, device_nll=True)
    host = tppl.compute_perplexity(tctx, tokens, n_ctx=N_CTX, device_nll=False)
    assert abs(dev.nll_sum - host.nll_sum) <= 1e-5 * dev.n_tokens
    assert tctx.kv.seq_ids == [None]                  # every chunk freed its lane


def test_kl_divergence(tcq4, tmp_path, capsys):
    path, tokens, jctx, tctx = tcq4
    toks = tokens[:N_CTX]
    own = tppl.host_logits(tctx, toks)
    r = tppl.kl_divergence(tctx, own, toks)
    assert r["n_pos"] == N_CTX and r["same_top_rate"] == 1.0
    assert r["mean_kl"] <= 1e-12 and r["max_kl"] <= 1e-12
    with jax.disable_jit():
        seq = jctx.new_sequence()
        jlogits = np.asarray(jctx.prefill(seq, toks), np.float32)
        jctx.kv.seq_rm(seq)
    r = tppl.kl_divergence(tctx, jlogits, toks)
    assert 0.0 <= r["mean_kl"] <= r["max_kl"] <= LP_ATOL
    # the verb's --save-logits / --kl-divergence-base round trip (f16 logits)
    text = tmp_path / "text.txt"
    text.write_text(TEXT)
    npz = tmp_path / "base.npz"
    main(["perplexity", "-m", str(path), "-f", str(text), "--n-ctx", str(N_CTX),
          "--save-logits", str(npz), "--device", "cpu"])
    z = np.load(npz)
    assert z["logits"].dtype == np.float16 and z["logits"].shape == (N_CTX, 256)
    assert z["tokens"].tolist() == toks
    capsys.readouterr()
    main(["perplexity", "-m", str(path), "--kl-divergence-base", str(npz), "--n-ctx",
          str(N_CTX), "--device", "cpu"])
    out = capsys.readouterr().out
    mean = float(out.split("mean=")[1].split()[0])
    assert "same_top=100.00%" in out and mean < 1e-4, out     # f16 rounding only


TASKS = [{"prompt": "the quick brown", "choices": [" fox", " dog!", " cat"], "answer": 0},
         {"prompt": "over the lazy", "choices": [" dog", " zz", " fox;"], "answer": 0}]


def test_multiple_choice_matches_jax(tmp_path_factory, tmp_path, capsys):
    """Choice scores on the dense tiny GGUF within their bound; picks equal
    wherever JAX's best score leads by more than twice the bound."""
    path = tmp_path_factory.mktemp("torch_mc") / "dense.gguf"
    export_random_gguf(jax_cfg(), path, seed=3, vocab_tokens=[chr(33 + i) for i in range(256)])
    jcfg, jw, md = _jax_load(path)
    jv = JaxVocab.from_gguf(md)
    cfg, w, tmd = load_model(path, device="cpu")
    tv = Vocab.from_gguf(tmd)
    tctx = InferenceContext(cfg, w, n_lanes=1, max_seq=N_CTX, device="cpu")
    with jax.disable_jit():
        jctx = JaxContext(jcfg, jw, n_lanes=1, max_seq=N_CTX)
        _, jpicks = jppl.multiple_choice_score(jctx, jv, TASKS)
        jscores = [[jppl.score_choice(jctx, jv.encode(t["prompt"], add_special=True),
                                      jv.encode(c, add_special=False)) for c in t["choices"]]
                   for t in TASKS]
    acc, picks = tppl.multiple_choice_score(tctx, tv, TASKS)
    for t, js, jp, tp in zip(TASKS, jscores, jpicks, picks):
        lens = [len(tv.encode(c, add_special=False)) for c in t["choices"]]
        ts = [tppl.score_choice(tctx, tv.encode(t["prompt"], add_special=True),
                                tv.encode(c, add_special=False)) for c in t["choices"]]
        for a, b, n in zip(ts, js, lens):
            assert abs(a - b) <= LP_ATOL * n
        norm = sorted((s / n for s, n in zip(js, lens)), reverse=True)
        if norm[0] - norm[1] > 2 * LP_ATOL:
            assert tp == jp
    assert acc == sum(p == t["answer"] for p, t in zip(picks, TASKS)) / len(TASKS)
    mc = tmp_path / "mc.json"
    mc.write_text(json.dumps(TASKS))
    main(["perplexity", "-m", str(path), "--multiple-choice", str(mc), "--n-ctx", str(N_CTX),
          "--device", "cpu"])
    assert f"multiple-choice accuracy = {acc:.4f} over 2 tasks" in capsys.readouterr().out


# -- dataset loaders on the fixtures of tests/test_task_loaders.py ------------

HELLASWAG = "\n".join([
    "Cooking: she takes the pan", "2",
    "and throws it away.", "and eats it raw.", "and puts it on the stove.", "and sings to it.",
    "Sports: he grabs the ball", "0",
    "and runs.", "and sleeps.", "and flies.", "and melts.",
]) + "\n"
WINOGRANDE = ('1,"The trophy doesn\'t fit in the suitcase because _ is too large.",'
              "trophy,suitcase,1\n"
              "2,Ann asked Mary what time _ should come over.,Ann,Mary,2\n")


def _mc_blob():
    def ser_s(t):
        b = t.encode()
        return struct.pack("<I", len(b)) + b

    def ser_mc(answers, labels):
        return (struct.pack("<I", len(answers)) + b"".join(ser_s(a) for a in answers)
                + struct.pack(f"<{len(labels)}i", *labels))

    task = ser_s("What is 2+2?") + ser_mc(["3", "4", "5"], [0, 1, 0]) + ser_mc([], [])
    return struct.pack("<I", 1) + struct.pack("<I", 0) + task


@pytest.mark.parametrize("loader,data", [("load_hellaswag", HELLASWAG),
                                         ("load_winogrande", WINOGRANDE),
                                         ("load_multiple_choice_bin", _mc_blob())])
def test_task_loaders_match_jax(loader, data):
    got = getattr(tppl, loader)(data)
    assert got == getattr(jppl, loader)(data) and got
    if loader == "load_hellaswag":
        assert got[0]["answer"] == 2 and got[0]["choices"][2] == " and puts it on the stove."
        with pytest.raises(ValueError):
            tppl.load_hellaswag("only\nfive\nlines\nin\nthis\n")


def test_hellaswag_and_winogrande_scores_run(tcq4):
    path, _, _, tctx = tcq4
    tv = Vocab.from_gguf(load_model(path, device="cpu")[2])
    acc = tppl.hellaswag_score(tctx, tv, tppl.load_hellaswag(HELLASWAG), n_tasks=1)
    assert acc in (0.0, 1.0)
    acc = tppl.winogrande_score(tctx, tv, tppl.load_winogrande(WINOGRANDE))
    assert acc in (0.0, 0.5, 1.0)
    assert tctx.kv.seq_ids == [None]


@pytest.mark.parametrize("over,vocab", [({}, True), ({"arch": "llama", "qk_norm": False}, False)])
def test_export_random_gguf_writes_the_jax_file(tmp_path, over, vocab):
    """The port's exporter (which gives chip_smoke.py its GGUF) writes the
    JAX exporter's file byte for byte from the same seed, dense and MoE."""
    from rrs_tpu_torch.models.export import export_random_gguf as texport
    from test_torch_common import tiny_vocab_tokens, torch_cfg

    tokens = tiny_vocab_tokens(256) if vocab else None
    jpath, tpath = tmp_path / "j.gguf", tmp_path / "t.gguf"
    export_random_gguf(jax_cfg(**over), jpath, seed=4, vocab_tokens=tokens)
    texport(torch_cfg(jax_cfg(**over)), tpath, seed=4, vocab_tokens=tokens)
    assert tpath.read_bytes() == jpath.read_bytes()
    moe = jax_cfg(n_experts=4, n_experts_used=2, n_ff_exp=256, arch="qwen3moe")
    export_random_gguf(moe, tmp_path / "moe_j.gguf", seed=4, vocab_tokens=tokens)
    texport(torch_cfg(moe), tmp_path / "moe_t.gguf", seed=4, vocab_tokens=tokens)
    assert (tmp_path / "moe_t.gguf").read_bytes() == (tmp_path / "moe_j.gguf").read_bytes()
