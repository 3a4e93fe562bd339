"""GGUF -> generate through rrs_tpu_torch against rrs_tpu: a random f32 GGUF
with a char vocab, quantized to TCQ4 (two layers' linears under channel
permutations) by the JAX package's quantizer, loaded by both packages; greedy
``generate`` must give the same tokens, the port's CLI must print text, and
the port's tokenizers must agree with the JAX package's.

The JAX package loads through its NumPy tile decode, which rounds the group
scales ``eff`` to bf16 as the port does; its native decode keeps them f32.
The JAX context runs op by op (``jax.disable_jit``), for the reason given in
tests/test_torch_model.py: under ``jit`` XLA's CPU backend skips bf16
rounding sites that the int4 activation quantizer turns into flipped codes."""

import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest

from rrs_tpu import native as jax_native
from rrs_tpu.models import loader as jax_loader
from rrs_tpu.models.export import export_random_gguf
from rrs_tpu.models.vocab import Vocab as JaxVocab
from rrs_tpu.models.vocab import _byte_encoder
from rrs_tpu.quantize.quantizer import quantize_model
from rrs_tpu.runtime.context import InferenceContext as JaxContext
from rrs_tpu_torch.models.loader import load_model
from rrs_tpu_torch.models.linear import Q8Linear, TCQ4Linear
from rrs_tpu_torch.models.vocab import Vocab
from rrs_tpu_torch.runtime.context import InferenceContext

from test_torch_common import jax_cfg

ROOT = Path(__file__).resolve().parent.parent
PROMPT = "the quick brown fox"
N_NEW = 6


@pytest.fixture(scope="module")
def tcq4_gguf(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_context")
    src, dst = d / "f32.gguf", d / "tcq4.gguf"
    cfg = jax_cfg()
    vocab = [chr(33 + i) if 33 + i < 288 else f"<t{i}>" for i in range(256)]
    export_random_gguf(cfg, src, seed=0, vocab_tokens=vocab)
    rng = np.random.default_rng(5)

    def perm(k):
        return np.concatenate([rng.permutation(256) + 256 * b for b in range(k // 256)])

    qkv_perm = perm(cfg.n_embd)       # one perm for q, k and v keeps them fusable
    perms = {f"blk.0.attn_{x}.weight": qkv_perm for x in "qkv"}
    perms["blk.1.ffn_down.weight"] = perm(cfg.n_ff)
    quantize_model(src, dst, perms=perms, verbose=False)
    return dst


def jax_load_model(path):
    with mock.patch.object(jax_native, "available", lambda: False):
        return jax_loader.load_model(path)


def test_loaded_layers_match_jax(tcq4_gguf):
    jcfg, jw, _ = jax_load_model(tcq4_gguf)
    cfg, w, _ = load_model(tcq4_gguf, device="cpu")
    assert (cfg.n_layers, cfg.n_embd, cfg.vocab_size) == (jcfg.n_layers, jcfg.n_embd,
                                                          jcfg.vocab_size)
    for jl, tl in ((jw.layers[0].wqkv, w.layers[0].wqkv),
                   (jw.layers[1].w_down, w.layers[1].w_down)):
        assert isinstance(tl, TCQ4Linear) and tl.gather is not None
        np.testing.assert_array_equal(tl.qs.numpy(), np.asarray(jl.qs))
        np.testing.assert_array_equal(tl.eff.float().numpy(), np.asarray(jl.eff, np.float32))
        np.testing.assert_array_equal(tl.gather.numpy(), np.asarray(jl.gather))
    assert w.layers[1].wqkv.gather is None
    assert isinstance(w.lm_head, Q8Linear)
    np.testing.assert_array_equal(w.lm_head.q.numpy(), np.asarray(jw.lm_head.q))


def test_generate_tokens_match_jax(tcq4_gguf):
    jcfg, jw, jmd = jax_load_model(tcq4_gguf)
    prompt = JaxVocab.from_gguf(jmd).encode(PROMPT)
    with jax.disable_jit():
        ref = JaxContext(jcfg, jw, n_lanes=1, max_seq=64).generate(prompt, N_NEW)
    cfg, w, md = load_model(tcq4_gguf, device="cpu")
    assert Vocab.from_gguf(md).encode(PROMPT) == prompt
    got = InferenceContext(cfg, w, n_lanes=1, max_seq=64, device="cpu").generate(prompt, N_NEW)
    assert len(got) == N_NEW
    assert got == ref


def test_cli_generate_prints_text(tcq4_gguf):
    r = subprocess.run(
        [sys.executable, "-m", "rrs_tpu_torch", "generate", "-m", str(tcq4_gguf),
         "-p", PROMPT, "-n", "4", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip(), r.stdout
    assert "perf: prompt" in r.stderr


def _bpe_metadata():
    """A byte-level BPE vocab: the 256 byte symbols plus a few merges."""
    byte_syms = list(_byte_encoder().values())
    merges = ["h e", "l l", "Ġ w", "o r", "he ll", "Ġw or", "hell o", "Ġwor l", "Ġworl d",
              "Ġ t", "Ġt he"]
    tokens = byte_syms + [m.replace(" ", "") for m in merges] + ["<|end|>"]
    return {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": "qwen2",
            "tokenizer.ggml.tokens": tokens, "tokenizer.ggml.merges": merges,
            "tokenizer.ggml.token_type": [1] * (len(tokens) - 1) + [3],
            "tokenizer.ggml.eos_token_id": len(tokens) - 1}


def _spm_metadata():
    """A sentencepiece vocab: control tokens, byte fallback and scored pieces."""
    pieces = ["▁", "h", "e", "l", "o", "w", "r", "d", "t", "▁h", "▁he", "ll", "▁hell",
              "▁hello", "▁w", "or", "▁wor", "▁world", "▁t", "▁the", ","]
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)] + pieces
    scores = [0.0] * 259 + [-float(i) for i in range(len(pieces))]
    types = [2, 3, 3] + [6] * 256 + [1] * len(pieces)
    return {"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.scores": scores, "tokenizer.ggml.token_type": types,
            "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
            "tokenizer.ggml.unknown_token_id": 0}


TEXTS = ["hello world", "Hello, wörld! 123", "  the   hello\n\tworld  ", "日本語 the",
         "hello<|end|>world</s>"]


@pytest.mark.parametrize("kind", ["bpe", "spm"])
def test_vocab_matches_jax(kind):
    md = _bpe_metadata() if kind == "bpe" else _spm_metadata()
    jv, tv = JaxVocab.from_gguf(md), Vocab.from_gguf(md)
    for text in TEXTS:
        ids = jv.encode(text)
        assert tv.encode(text) == ids, text
        assert tv.encode(text, add_special=False, parse_special=False) == jv.encode(
            text, add_special=False, parse_special=False), text
        assert tv.decode(ids) == jv.decode(ids), text
        assert tv.decode(ids, skip_special=True) == jv.decode(ids, skip_special=True), text
