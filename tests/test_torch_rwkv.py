"""RWKV6 through rrs_tpu_torch against rrs_tpu: the file, the model, the
world tokenizer and the CLI verbs on recurrent files.

The file is tests/test_rwkv.py's hand-built GGUF (JAX's writer) at 2 layers,
E = 256, head size 64, FF 512, extra widths 32 / 64, ``rescale_every_n_layers``
1 (so the halving runs), its norms around 1 and its lerps and decay drawn at
the scales the published weights have, with an ``rwkv`` vocabulary of 256
strings; ``rwkv6qwen2`` is the same file under that architecture, which
both packages run through the RWKV6 forward. JAX runs jitted, once per file.

Held: the config field by field; 40-token prefill logits at rel L2 <= 1e-2
and within 2e-2 of the largest logit; greedy tokens identical (up to a bf16
tie in JAX's logits); decode against prefill within JAX's 2e-3 on f32
caches (tests/test_rwkv.py); the world tokenizer's ids equal JAX's on
tests/test_rwkv.py's cases and a longer text; and ``generate`` / ``chat``
on the RWKV6 file, ``generate`` on a Jamba one, through the CLI, which
builds its context with make_context.
"""

import io
from unittest import mock

import numpy as np
import pytest
import torch

from rrs_tpu import native as jax_native
from rrs_tpu.models import loader as jax_loader
from rrs_tpu.models.config import ModelConfig as JaxConfig
from rrs_tpu.models.vocab import Vocab as JaxVocab
from rrs_tpu.runtime import recurrent as jax_recurrent
from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.models.loader import load_model
from rrs_tpu_torch.models.vocab import Vocab
from rrs_tpu_torch.runtime import recurrent

from test_torch_common import assert_same_greedy, rewrite_gguf, torch_cfg

E, HS, FF, EX, DEX, V = 256, 64, 512, 32, 64, 256
PROMPT = [int(t) for t in np.random.default_rng(5).integers(0, V, 40)]
# an rwkv vocabulary: single characters, then multi-character strings
WORLD = [chr(32 + i) for i in range(95)] + [
    "th", "he", "the", " the", "in", "ing", " in", "er", "an", "and", " and", "hello",
    " world", "wor", "ld", "ll", "o w", "Hello", ",", "!!", "  "] + \
    [f"<{i}>" for i in range(140)]


def write_rwkv(path, arch="rwkv6"):
    from rrs_tpu.gguf.writer import GGUFWriter

    rng = np.random.default_rng(4)
    w = GGUFWriter(path)
    w.add_string("general.architecture", arch)
    for k, v in (("block_count", 2), ("context_length", 512), ("embedding_length", E),
                 ("feed_forward_length", FF), ("wkv.head_size", HS), ("time_mix_extra_dim", EX),
                 ("time_decay_extra_dim", DEX), ("rescale_every_n_layers", 1), ("vocab_size", V)):
        w.add_uint32(f"{arch}.{k}", v)
    w.add_string("tokenizer.ggml.model", "rwkv")
    w.add_array("tokenizer.ggml.tokens", WORLD)
    w.add_array("tokenizer.ggml.token_type", [1] * V)

    def t(name, shape, s=0.05, mean=0.0):
        w.add_tensor(name, (mean + rng.standard_normal(shape) * s).astype(np.float32))

    t("token_embd.weight", (V, E), 0.1)
    t("token_embd_norm.weight", (E,), 0.2, 1.0)
    t("token_embd_norm.bias", (E,), 0.05)
    for i in range(2):
        p = f"blk.{i}"
        for nm in ("attn_norm", "attn_norm_2", "time_mix_ln"):
            t(f"{p}.{nm}.weight", (E,), 0.2, 1.0)
            t(f"{p}.{nm}.bias", (E,), 0.05)
        t(f"{p}.time_mix_w1.weight", (5 * EX, E), 0.02)
        t(f"{p}.time_mix_w2.weight", (5, E, EX), 0.02)
        t(f"{p}.time_mix_lerp_x.weight", (1, 1, E), 0.2, 0.5)
        t(f"{p}.time_mix_lerp_fused.weight", (5, 1, 1, E), 0.2, 0.5)
        t(f"{p}.time_mix_first.weight", (E // HS, HS), 0.3)
        t(f"{p}.time_mix_decay.weight", (E,), 0.5, -1.0)
        t(f"{p}.time_mix_decay_w1.weight", (DEX, E), 0.02)
        t(f"{p}.time_mix_decay_w2.weight", (E, DEX), 0.02)
        for nm in ("time_mix_key", "time_mix_value", "time_mix_receptance", "time_mix_gate",
                   "time_mix_output", "channel_mix_receptance"):
            t(f"{p}.{nm}.weight", (E, E))
        t(f"{p}.channel_mix_lerp_k.weight", (1, 1, E), 0.2, 0.5)
        t(f"{p}.channel_mix_lerp_r.weight", (1, 1, E), 0.2, 0.5)
        t(f"{p}.channel_mix_key.weight", (FF, E))
        t(f"{p}.channel_mix_value.weight", (E, FF))
    t("output_norm.weight", (E,), 0.2, 1.0)
    t("output_norm.bias", (E,), 0.05)
    t("output.weight", (V, E), 0.1)
    w.write()
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_rwkv")
    rwkv = write_rwkv(d / "rwkv6.gguf")
    qwen2 = rewrite_gguf(rwkv, d / "rwkv6qwen2.gguf",
                         kv={"general.architecture": "rwkv6qwen2",
                             **{f"rwkv6qwen2.{k}": v for k, v in (
                                 ("block_count", 2), ("embedding_length", E),
                                 ("feed_forward_length", FF), ("wkv.head_size", HS),
                                 ("time_mix_extra_dim", EX), ("time_decay_extra_dim", DEX),
                                 ("rescale_every_n_layers", 1), ("vocab_size", V))}})
    return {"rwkv6": rwkv, "rwkv6qwen2": qwen2}


def jax_load(path):
    with mock.patch.object(jax_native, "available", lambda: False):
        return jax_loader.load_model(path)


_JAX_RUNS: dict = {}


def jax_run(path, n_new=6):
    if str(path) not in _JAX_RUNS:
        jcfg, jw, _ = jax_load(path)
        ctx = jax_recurrent.make_context(jcfg, jw, n_lanes=1, max_seq=128)
        toks = ctx.generate(PROMPT, n_new)
        seq = ctx.new_sequence()
        forced = np.asarray(ctx.prefill(seq, PROMPT + toks[:-1]), np.float32)
        _JAX_RUNS[str(path)] = jcfg, toks, forced
    return _JAX_RUNS[str(path)]


@pytest.mark.parametrize("arch", ["rwkv6", "rwkv6qwen2"])
def test_config_matches_jax(files, arch):
    from rrs_tpu.gguf.reader import read_gguf as jax_read_gguf

    g = jax_read_gguf(files[arch])
    md = dict(g.metadata)
    g.close()
    cfg = ModelConfig.from_gguf(md)
    assert cfg == torch_cfg(JaxConfig.from_gguf(md)) and cfg.arch == arch
    assert (cfg.rwkv_head_size, cfg.rwkv_tm_extra, cfg.rwkv_decay_extra,
            cfg.rwkv_rescale_every) == (HS, EX, DEX, 1)
    assert cfg.is_recurrent and not cfg.is_hybrid


@pytest.mark.parametrize("arch", ["rwkv6", "rwkv6qwen2"])
def test_logits_and_greedy_tokens_match_jax(files, arch):
    jcfg, ref_toks, forced = jax_run(files[arch])
    cfg, w, _ = load_model(files[arch], device="cpu")
    assert cfg == torch_cfg(jcfg)
    ctx = recurrent.make_context(cfg, w, max_seq=128, device="cpu")
    assert type(ctx).__name__ == "RecurrentContext"
    got = ctx.prefill(ctx.new_sequence(), PROMPT).float().numpy()
    ref = forced[:len(PROMPT)]
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 1e-2
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()
    toks = recurrent.make_context(cfg, w, max_seq=128, device="cpu").generate(PROMPT, 6)
    assert_same_greedy(toks, ref_toks, forced[len(PROMPT) - 1:])


def test_decode_matches_prefill(files):
    """f32 weights and caches, JAX's 2e-3 (tests/test_rwkv.py)."""
    cfg, w, _ = load_model(files["rwkv6"], device="cpu", dtype=torch.float32)
    toks = PROMPT[:6]
    c1 = recurrent.make_context(cfg, w, max_seq=64, device="cpu", kv_dtype=torch.float32)
    full = c1.prefill(c1.new_sequence(), toks).numpy()
    c2 = recurrent.make_context(cfg, w, max_seq=64, device="cpu", kv_dtype=torch.float32)
    s = c2.new_sequence()
    step = [c2.prefill(s, toks[:1])[0].numpy()]
    step += [c2.decode({s: t})[s].numpy() for t in toks[1:]]
    np.testing.assert_allclose(np.stack(step), full, rtol=2e-3, atol=2e-3)


TOKENIZER_CASES = {
    "greedy longest match": (["<unk>", "h", "e", "l", "o", "he", "hell", "hello", " ", " w",
                              "wor", "world", "r", "d"], "hello world"),
    "unknown char": (["<unk>", "h", "e", "l", "o", "he", "hell", "hello", " ", " w", "wor",
                      "world", "r", "d"], "hZ"),
    "shorter vocab": (["<unk>", "h", "e", "l", "o", "he", "hell"], "hello"),
    "longer text": (WORLD, "Hello, the world and the thing in hello world!!  the end"),
}


@pytest.mark.parametrize("case", list(TOKENIZER_CASES))
def test_world_tokenizer_ids_match_jax(case):
    toks, text = TOKENIZER_CASES[case]
    kw = dict(model="rwkv", tokens=toks, scores=None, token_types=[1] * len(toks), merges=None,
              unk_id=0 if toks[0] == "<unk>" else -1, add_bos=False)
    got = Vocab(**kw).encode(text, add_special=False)
    ref = JaxVocab(**kw).encode(text, add_special=False)
    assert got == ref and len(got) > 0
    assert Vocab(**kw).decode(got) == JaxVocab(**kw).decode(ref)
    if case == "greedy longest match":
        assert got == [7, 9, 4, 12, 3, 13]


def _jax_text(path, prompt_text, n):
    jcfg, jw, md = jax_load(path)
    vocab = JaxVocab.from_gguf(md)
    ctx = jax_recurrent.make_context(jcfg, jw, n_lanes=1, max_seq=256)
    return vocab.decode(ctx.generate(vocab.encode(prompt_text), n))


def test_cli_generate_and_chat_on_recurrent_files(files, tmp_path, capsys, monkeypatch):
    """``generate`` on the RWKV6 file prints JAX's greedy text; ``chat``
    answers a turn and exits; ``generate`` runs a Jamba file (hybrid
    memory)."""
    from rrs_tpu_torch.__main__ import main

    from test_torch_recurrent import write_jamba

    main(["generate", "-m", str(files["rwkv6"]), "-p", "hello the world", "-n", "5",
          "--temp", "0", "--device", "cpu"])
    out = capsys.readouterr()
    assert out.out.rstrip("\n") == _jax_text(files["rwkv6"], "hello the world", 5)
    assert "gen 5 tok" in out.err
    monkeypatch.setattr("sys.stdin", io.StringIO("hello\n/exit\n"))
    main(["chat", "-m", str(files["rwkv6"]), "--device", "cpu", "--n-predict", "3",
          "--temp", "0"])
    out = capsys.readouterr()
    assert "chat:" in out.err and out.out.count("> ") == 2
    jamba = write_jamba(tmp_path / "jamba.gguf")
    main(["generate", "-m", str(jamba), "-p", "abc", "-n", "3", "--temp", "0", "--device",
          "cpu"])
    assert "gen 3 tok" in capsys.readouterr().err
