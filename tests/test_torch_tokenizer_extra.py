"""The port's WordPiece (``bert``), Unigram (``t5`` / ``unigram``) and PLaMo-2
tokenizers (``rrs_tpu_torch/models/vocab.py``) against the JAX package's:
the same ids and the same decoded text on the vocabularies of
tests/test_tokenizer.py and on 200 seeded random strings each, built
directly and read back from a GGUF; and the reference's BERT fixture corpus
where its files are present."""

import numpy as np
import pytest

from rrs_tpu.gguf.writer import GGUFWriter as JaxWriter
from rrs_tpu.models.vocab import Vocab as JaxVocab
from rrs_tpu_torch.gguf.reader import read_gguf
from rrs_tpu_torch.models.vocab import Vocab

from test_tokenizer import FIXTURES

BYTES = [f"<0x{b:02X}>" for b in range(256)]

VOCABS = {
    "bert": dict(model="bert",
                 tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]", "▁hello", "▁world", "▁un", "want",
                         "ed", "▁runn", "ing", "▁,", "▁want", "▁a", "b", "▁é", "▁中", "c"],
                 scores=None, token_types=[3, 2, 3, 3] + [1] * 14, merges=None, unk_id=1,
                 add_bos=False),
    "t5": dict(model="t5",
               tokens=["<unk>", "▁", "▁hello", "▁world", "hell", "o", "▁h", "w", "orld", "▁wor",
                       "ld", "a", "b", "▁a", ",", "é"],
               scores=[-10.0, -2.0, -1.0, -1.5, -3.0, -2.5, -3.5, -4.0, -4.5, -3.0, -2.0, -5.0,
                       -5.5, -4.0, -3.0, -6.0],
               token_types=[2] + [1] * 15, merges=None, unk_id=0, add_bos=False,
               add_space_prefix=True),
    "unigram": dict(model="unigram",
                    tokens=["<unk>", "▁", "▁hello", "hello", "▁world", "o", "l", "▁h", "e"],
                    scores=[-10.0, -2.0, -1.0, -1.2, -1.5, -2.5, -2.6, -3.5, -2.7],
                    token_types=[2] + [1] * 8, merges=None, unk_id=0, add_bos=False,
                    add_space_prefix=True),
    "plamo2": dict(model="plamo2",
                   tokens=(["<|plamo:unk|>", "<|plamo:bos|>", "<|plamo:eos|>", "<|plamo:pad|>"]
                           + BYTES + ["hello", "hell", "o", " world", " wor", "ld", "h", "w",
                                      "é", "中文", " "]),
                   scores=([0.0] * 260 + [-1.0, -3.0, -2.5, -1.5, -3.0, -2.0, -4.0, -4.5, -2.0,
                                          -1.0, -0.5]),
                   token_types=[3] * 4 + [6] * 256 + [1] * 11, merges=None, unk_id=0,
                   bos_id=1, eos_id=2, add_bos=False, add_space_prefix=False),
}
FIXED = ["hello world", "unwanted running", "HeLLo", "héllo", "hello, xyzzy", "hello ZZZ",
         "Z", "é", "helloZld", "  hello   world  ", "中文 abc", "", "a,b,c"]
# characters that hit every branch: pieces, spaces, punctuation, accents,
# CJK, controls and characters no vocabulary holds
ALPHABET = list("helowrdunatigbc ,.!?") + ["é", "É", "中", "文", "\t", "\n", "Z", "ß", "😀",
                                          "́", "\x07"]


def _pair(name):
    kw = VOCABS[name]
    return Vocab(**kw), JaxVocab(**kw)


def _random_strings(seed: int, n: int = 200) -> list[str]:
    rng = np.random.default_rng(seed)
    return ["".join(ALPHABET[int(i)] for i in rng.integers(0, len(ALPHABET), rng.integers(0, 24)))
            for _ in range(n)]


def _same(port, ref, texts):
    for text in texts:
        ids = port.encode(text, add_special=False)
        assert ids == ref.encode(text, add_special=False), text
        assert port.decode(ids) == ref.decode(ids), text


@pytest.mark.parametrize("name", sorted(VOCABS))
def test_fixed_cases_match_jax(name):
    port, ref = _pair(name)
    _same(port, ref, FIXED)


@pytest.mark.parametrize("name", sorted(VOCABS))
def test_random_strings_match_jax(name):
    port, ref = _pair(name)
    _same(port, ref, _random_strings(sorted(VOCABS).index(name)))


def test_known_encodings():
    """The expected ids of tests/test_tokenizer.py, from the port alone."""
    bert = Vocab(**VOCABS["bert"])
    assert bert.encode("unwanted running", add_special=False) == [6, 7, 8, 9, 10]
    assert bert.encode("hello, xyzzy", add_special=False) == [4, 11, 1]
    t5 = Vocab(**VOCABS["t5"])
    assert t5.encode("hello world", add_special=False) == [2, 3]
    plamo = Vocab(**VOCABS["plamo2"])
    p0 = 4 + 256
    assert plamo.encode("helloZld", add_special=False) == [p0, 4 + 0x5A, p0 + 5]
    assert plamo.decode([p0, 4 + 0xC3, 4 + 0xA9, p0 + 3]) == "helloé world"


@pytest.mark.parametrize("name", ["bert", "t5", "plamo2"])
def test_from_gguf_matches_jax(tmp_path, name):
    """The same vocabulary read back from a GGUF's tokenizer keys (the
    ``tokenize`` verb's route)."""
    kw = VOCABS[name]
    path = tmp_path / "v.gguf"
    w = JaxWriter(path)
    w.add_string("general.architecture", "llama")
    w.add_string("tokenizer.ggml.model", kw["model"])
    w.add_array("tokenizer.ggml.tokens", kw["tokens"])
    if kw["scores"] is not None:
        w.add_array("tokenizer.ggml.scores", [float(s) for s in kw["scores"]])
    w.add_array("tokenizer.ggml.token_type", kw["token_types"])
    w.add_uint32("tokenizer.ggml.unknown_token_id", kw["unk_id"])
    w.write()
    with read_gguf(path) as g:
        port = Vocab.from_gguf(g.metadata)
        ref = JaxVocab.from_gguf(dict(g.metadata))
    assert port.model == name
    _same(port, ref, FIXED + _random_strings(7, 50))
    for text in FIXED:
        assert port.encode(text) == ref.encode(text), text


def test_bert_fixture_corpus():
    """The reference's test-tokenizer-0 corpus for a BERT vocabulary."""
    stem = "ggml-vocab-bert-bge"
    path = FIXTURES / f"{stem}.gguf"
    if not path.exists():
        pytest.skip(f"{path} not present")
    with read_gguf(path) as g:
        vocab = Vocab.from_gguf(g.metadata)
    texts = (FIXTURES / f"{stem}.gguf.inp").read_text(encoding="utf-8").split(
        "\n__ggml_vocab_test__\n")
    out = (FIXTURES / f"{stem}.gguf.out").read_text(encoding="utf-8").splitlines()
    for text, line in zip(texts, out):
        assert vocab.encode(text, add_special=False, parse_special=False) == \
            [int(t) for t in line.split()], text
