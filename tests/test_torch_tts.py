"""Text to speech in rrs_tpu_torch against rrs_tpu: the DSP and the WAV
bit for bit, the prompt and the code extraction, the WavTokenizer decoder on
weights carried across and from a GGUF, ``synthesize`` on a 2-layer OuteTTS-
style model, and the ``tts`` verb as a process."""

import subprocess
import sys
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.tts import dsp as jdsp
from rrs_tpu.tts import pipeline as jpipe
from rrs_tpu.tts import vocoder as jvoc
from rrs_tpu_torch.tts import dsp, pipeline, vocoder

from test_torch_common import (assert_same_greedy, jax_cfg, rewrite_gguf, tiny_vocab_tokens,
                               torch_cfg, torch_vocoder)

ROOT = Path(__file__).resolve().parent.parent
VOC_TOL = 1e-5          # f32 both, rel L2


def _rel_l2(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _sine_embd(n_codes: int = 20, k_bin: int = 40) -> np.ndarray:
    """The frames of tests/test_tts.py's steady tone at bin k_bin."""
    half = dsp.N_FFT // 2 + 1
    embd = np.full((n_codes, 2 * half), -30.0, np.float64)
    for li in range(n_codes):
        embd[li, k_bin] = 0.0
        embd[li, half + k_bin] = -2.0 * np.pi * k_bin * (li * dsp.N_HOP) / dsp.N_FFT
    return embd


# -- the DSP and the prompt -------------------------------------------------------

@pytest.mark.parametrize("case", ["sine", "random", "one-code"])
def test_embd_to_audio_bit_equal(case):
    rng = np.random.default_rng(1)
    embd = {"sine": _sine_embd(),
            "random": rng.standard_normal((37, 1282)) * 2.0,
            "one-code": rng.standard_normal((1, 1282)).astype(np.float32)}[case]
    got, ref = dsp.embd_to_audio(embd), jdsp.embd_to_audio(embd)
    assert got.dtype == ref.dtype == np.float32
    n = embd.shape[0]
    assert got.shape == ((n - 1) * dsp.N_HOP + dsp.N_WIN - (dsp.N_WIN - dsp.N_HOP),)
    np.testing.assert_array_equal(got, ref)


def test_hann_and_fold_bit_equal():
    for n, periodic in ((8, True), (1280, True), (9, False)):
        np.testing.assert_array_equal(dsp.hann_window(n, periodic), jdsp.hann_window(n, periodic))
    frames = np.random.default_rng(2).standard_normal((7, 64))
    for n_out, n_pad in ((64 + 6 * 16, 24), (40, 0), (100, 8)):
        np.testing.assert_array_equal(dsp.fold(frames, n_out, 64, 16, n_pad),
                                      jdsp.fold(frames, n_out, 64, 16, n_pad))


def test_save_wav16_byte_equal(tmp_path):
    audio = np.concatenate([np.sin(np.linspace(0, 100, 2400)) * 1.3,
                            np.random.default_rng(3).standard_normal(500)]).astype(np.float32)
    for rate in (24000, 16000):
        a = dsp.save_wav16(tmp_path / f"port{rate}.wav", audio, sample_rate=rate)
        b = jdsp.save_wav16(tmp_path / f"jax{rate}.wav", audio, sample_rate=rate)
        assert Path(a).read_bytes() == Path(b).read_bytes()
    with wave.open(str(tmp_path / "port24000.wav"), "rb") as f:
        assert (f.getframerate(), f.getnchannels(), f.getsampwidth(), f.getnframes()) == \
            (24000, 1, 2, audio.size)


TEXTS = ["Hello, World!", "A-B c.d", "the_quick/brown\\fox, 42 times: déjà vu?!", "", "   ",
         "Ünïcödé ÀÉÎ ſ and emoji 🙂 too"]


@pytest.mark.parametrize("text", TEXTS)
def test_prompt_matches_jax(text):
    assert pipeline.process_text(text) == jpipe.process_text(text)
    assert pipeline.format_prompt(text) == jpipe.format_prompt(text)


def test_extract_codes_matches_jax():
    toks = [5, pipeline.CODE_TOKEN_MIN, pipeline.CODE_TOKEN_MIN + 7, 200_000,
            pipeline.CODE_TOKEN_MIN - 1, pipeline.CODE_TOKEN_MAX, pipeline.CODE_TOKEN_MAX + 1]
    assert (pipeline.CODE_TOKEN_MIN, pipeline.CODE_TOKEN_MAX) == \
        (jpipe.CODE_TOKEN_MIN, jpipe.CODE_TOKEN_MAX)
    assert pipeline.extract_codes(toks) == jpipe.extract_codes(toks) == [0, 7, 4100]


# -- the vocoder ---------------------------------------------------------------------

def test_random_vocoder_and_forward_match_jax():
    """The port's random vocoder is JAX's, carried across; the forward over
    24 codes within VOC_TOL; a code past the table reads NaN rows in both."""
    jw = jvoc.random_vocoder(n_codes_vocab=256, c=64, n_embd_out=1282, n_convnext=2, seed=4)
    w = torch_vocoder(jw)
    mine = vocoder.random_vocoder(n_codes_vocab=256, c=64, n_embd_out=1282, n_convnext=2,
                                  seed=4, device="cpu")
    for a, b in zip(mine.tensors(), w.tensors()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert [p.kind for p in mine.posnet] == ["res", "res", "attn", "res", "res", "norm"]
    codes = np.random.default_rng(5).integers(0, 256, 24)
    got = vocoder.vocoder_forward(w, codes)
    with jax.disable_jit():
        ref = np.asarray(jvoc.vocoder_forward(jw, jnp.asarray(codes, jnp.int32)))
    assert got.shape == ref.shape == (24, 1282)
    assert _rel_l2(got.numpy(), ref) <= VOC_TOL
    codes[3] = 300
    got = vocoder.vocoder_forward(w, codes).numpy()
    with jax.disable_jit():
        ref = np.asarray(jvoc.vocoder_forward(jw, jnp.asarray(codes, jnp.int32)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got).any()


def write_vocoder(path, seed: int, n_codes: int = 300, c_embd: int = 32, c: int = 64,
                  n_out: int = 66, n_convnext: int = 3):
    """A WavTokenizer-dec GGUF of random weights under llama.cpp's names,
    written with the JAX package's writer: the code embedding ``c_embd``
    wide, the model ``c`` wide (as WavTokenizer's 512 and 768), each array in
    the NumPy order of ggml's ne (a conv (Cout, Cin, k), a linear (out, in))."""
    from rrs_tpu.gguf.writer import GGUFWriter

    rng = np.random.default_rng(seed)
    w = GGUFWriter(path)
    w.add_string("general.architecture", "wavtokenizer-dec")

    def add(name, *shape, s=0.05, base=0.0):
        w.add_tensor(name, (base + rng.standard_normal(shape) * s).astype(np.float32))

    add("token_embd.weight", n_codes, c_embd, s=0.1)
    add("conv1d.weight", c, c_embd, 7)
    add("conv1d.bias", c)
    for il in range(6):
        p = f"posnet.{il}"
        if il == 2:
            add(f"{p}.attn_norm.weight", c, base=1.0)
            add(f"{p}.attn_norm.bias", c)
            for n in ("attn_q", "attn_k", "attn_v", "attn_output"):
                add(f"{p}.{n}.weight", c, c, 1)
                add(f"{p}.{n}.bias", c)
        elif il == 5:
            add(f"{p}.norm.weight", c, base=1.0)
            add(f"{p}.norm.bias", c)
        else:
            for j in (1, 2):
                add(f"{p}.norm{j}.weight", c, base=1.0)
                add(f"{p}.norm{j}.bias", c)
                add(f"{p}.conv{j}.weight", c, c, 3)
                add(f"{p}.conv{j}.bias", c)
    add("token_embd_norm.weight", c, base=1.0)
    add("token_embd_norm.bias", c)
    for il in range(n_convnext):
        p = f"convnext.{il}"
        add(f"{p}.dw.weight", c, 1, 7)
        add(f"{p}.dw.bias", c)
        add(f"{p}.norm.weight", c, base=1.0)
        add(f"{p}.norm.bias", c)
        add(f"{p}.pw1.weight", 3 * c, c)
        add(f"{p}.pw1.bias", 3 * c)
        add(f"{p}.pw2.weight", c, 3 * c)
        add(f"{p}.pw2.bias", c)
        add(f"{p}.gamma", c, s=0.1)
    add("output_norm.weight", c, base=1.0)
    add("output_norm.bias", c)
    add("output.weight", n_out, c, s=0.02)
    add("output.bias", n_out)
    w.write()
    return path


def test_load_vocoder_matches_jax(tmp_path):
    """A file whose code embedding (32) is narrower than the model (64): the
    port's tensors are JAX's in conv1d's layout, and the forward agrees."""
    path = write_vocoder(tmp_path / "voc.gguf", seed=6)
    jw = jvoc.load_vocoder(path)
    w = vocoder.load_vocoder(path, device="cpu")
    for a, b in zip(w.tensors(), torch_vocoder(jw).tensors()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert w.embed.shape == (300, 32) and w.conv_w.shape == (64, 32, 7) and len(w.convnext) == 3
    codes = np.random.default_rng(7).integers(0, 300, 40)
    got = vocoder.vocoder_forward(w, codes)
    with jax.disable_jit():
        ref = np.asarray(jvoc.vocoder_forward(jw, jnp.asarray(codes, jnp.int32)))
    assert got.shape == ref.shape == (40, 66)
    assert _rel_l2(got.numpy(), ref) <= VOC_TOL
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            vocoder.load_vocoder(path)


# -- synthesize and the verb ------------------------------------------------------------

VOCAB = 157_696                 # OuteTTS-0.2-500M's extended Qwen2.5 vocabulary
SPECIALS = {151644: "<|im_start|>", 151645: "<|im_end|>", 151646: "<|text_start|>",
            151647: "<|text_end|>", 151648: "<|text_sep|>", 151649: "<|audio_start|>"}
EOS = 151645
TEXT = "Hello world, this is a test"
N_CODES = 24


@pytest.fixture(scope="module")
def tts_files(tmp_path_factory):
    """A 2-layer qwen2 (E = 64, qkv biases, tied embeddings) over OuteTTS's
    vocabulary size with its special tokens, exported by the JAX package
    with the code rows of the tied embedding scaled 4x, so that greedy
    decoding emits codes as a trained model does; and a vocoder GGUF over
    4,101 codes. Returns (model path, vocoder path)."""
    from rrs_tpu.models.export import export_random_gguf

    d = tmp_path_factory.mktemp("tts")
    cfg = jax_cfg(arch="qwen2", n_embd=64, n_heads=4, n_kv_heads=2, head_dim=16, n_ff=128,
                  vocab_size=VOCAB, context_length=4096, qk_norm=False, attn_bias=True,
                  tie_embeddings=True)
    toks = tiny_vocab_tokens(VOCAB)
    types = [1] * VOCAB
    for i, t in SPECIALS.items():
        toks[i], types[i] = t, 3
    export_random_gguf(cfg, d / "raw.gguf", seed=8, vocab_tokens=toks, vocab_types=types)

    def favour(name, arr):
        if name == "token_embd.weight":
            arr = arr.copy()
            arr[pipeline.CODE_TOKEN_MIN:pipeline.CODE_TOKEN_MAX + 1] *= 4.0
        return {name: arr}

    model = rewrite_gguf(d / "raw.gguf", d / "outetts.gguf", edit=favour,
                         kv={"qwen2.tie_word_embeddings": True,
                             "tokenizer.ggml.bos_token_id": 151643,
                             "tokenizer.ggml.eos_token_id": EOS})
    voc = write_vocoder(d / "voc.gguf", seed=9, n_codes=4101, c_embd=32, c=64, n_out=1282,
                        n_convnext=2)
    return model, voc


def test_synthesize_matches_jax(tts_files, tmp_path):
    """Greedy codes by the repository's rule against JAX's (f32 weights and
    caches, max_seq 4,096 as the verb builds them), then the WAV within a
    rounding step of JAX's and the waveform within VOC_TOL."""
    from rrs_tpu.models.loader import load_model as jload
    from rrs_tpu.models.vocab import Vocab as JaxVocab
    from rrs_tpu.runtime.context import InferenceContext as JaxContext
    from rrs_tpu_torch.models.loader import load_model
    from rrs_tpu_torch.models.vocab import Vocab
    from rrs_tpu_torch.runtime.context import InferenceContext

    model, voc = tts_files
    jcfg, jw, jmd = jload(model, dtype=np.float32)
    cfg, w, md = load_model(model, dtype=torch.float32, device="cpu")
    assert cfg == torch_cfg(jcfg) and cfg.tie_embeddings
    vocab, jvocab = Vocab.from_gguf(md), JaxVocab.from_gguf(jmd)
    prompt = vocab.encode(pipeline.format_prompt(TEXT), add_special=True)
    assert prompt == jvocab.encode(jpipe.format_prompt(TEXT), add_special=True)
    assert [t for t in prompt if t in SPECIALS] == [151644, 151646] + [151648] * 5 + \
        [151647, 151649]

    ctx = InferenceContext(cfg, w, n_lanes=1, max_seq=4096, kv_dtype=torch.float32, device="cpu")
    voc_w = vocoder.load_vocoder(voc, device="cpu")
    got_path, n = pipeline.synthesize(ctx, vocab, voc_w, TEXT, max_codes=N_CODES,
                                      out_path=tmp_path / "port.wav")
    toks = ctx.generate(prompt, N_CODES, stop_tokens=(EOS,))
    with jax.disable_jit():
        jctx = JaxContext(jcfg, jw, n_lanes=1, max_seq=4096, kv_dtype=np.float32)
        ref_path, jn = jpipe.synthesize(jctx, jvocab, jvoc.load_vocoder(voc), TEXT,
                                        max_codes=N_CODES, out_path=tmp_path / "jax.wav")
        ref = jctx.generate(prompt, N_CODES, stop_tokens=(EOS,))
        rows = np.asarray(jctx.prefill(jctx.new_sequence(), prompt + ref[:-1]), np.float32)
    assert_same_greedy(toks, ref, rows[len(prompt) - 1:])
    assert toks == ref and n == jn == len(pipeline.extract_codes(ref)) >= N_CODES // 2
    pcm, jpcm = (_pcm(p) for p in (got_path, ref_path))
    assert pcm.shape == jpcm.shape == ((n - 1) * dsp.N_HOP + dsp.N_WIN - (dsp.N_WIN - dsp.N_HOP),)
    assert np.abs(pcm.astype(np.int32) - jpcm).max() <= 1
    codes = pipeline.extract_codes(toks)
    wave_port = dsp.embd_to_audio(vocoder.vocoder_forward(voc_w, codes).numpy())
    with jax.disable_jit():
        wave_jax = jdsp.embd_to_audio(np.asarray(jvoc.vocoder_forward(
            jvoc.load_vocoder(voc), jnp.asarray(codes, jnp.int32))))
    assert _rel_l2(wave_port, wave_jax) <= VOC_TOL


def test_synthesize_without_codes_raises(tts_files):
    """A model that emits no code token raises, as JAX's does."""
    from rrs_tpu_torch.models.loader import load_model
    from rrs_tpu_torch.models.vocab import Vocab
    from rrs_tpu_torch.runtime.context import InferenceContext

    cfg, w, md = load_model(tts_files[0], dtype=torch.float32, device="cpu")
    vocab = Vocab.from_gguf(md)
    ctx = InferenceContext(cfg, w, n_lanes=1, max_seq=256, device="cpu")
    voc_w = vocoder.load_vocoder(tts_files[1], device="cpu")
    ctx.generate = lambda toks, n, params=None, stop_tokens=(): [5, EOS - 1]
    with pytest.raises(ValueError, match="no audio codes"):
        pipeline.synthesize(ctx, vocab, voc_w, TEXT, max_codes=4)


def _pcm(path) -> np.ndarray:
    with wave.open(str(path), "rb") as f:
        assert (f.getframerate(), f.getnchannels(), f.getsampwidth()) == (24000, 1, 2)
        return np.frombuffer(f.readframes(f.getnframes()), np.int16)


def test_tts_verb_matches_jax(tts_files, tmp_path):
    """``python -m rrs_tpu_torch tts ... --device cpu`` as a process writes
    the WAV and prints the line of JAX's verb, run here as that verb runs
    (its ``_load`` with max_seq 4,096, then ``load_vocoder`` and
    ``synthesize``)."""
    from rrs_tpu.__main__ import _load

    model, voc = tts_files
    out = tmp_path / "port.wav"
    r = subprocess.run([sys.executable, "-m", "rrs_tpu_torch", "tts", "-m", str(model),
                        "-mv", str(voc), "-p", TEXT, "-o", str(out), "--max-codes",
                        str(N_CODES), "--device", "cpu"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with jax.disable_jit():
        _, jvocab, jctx = _load(str(model), max_seq=4096)
        path, n = jpipe.synthesize(jctx, jvocab, jvoc.load_vocoder(voc), TEXT,
                                   max_codes=N_CODES, out_path=str(tmp_path / "jax.wav"))
    assert r.stdout.strip().splitlines()[-1] == f"wrote {out} ({n} audio codes)"
    pcm, jpcm = _pcm(out), _pcm(path)
    assert pcm.shape == jpcm.shape and np.abs(pcm.astype(np.int32) - jpcm).max() <= 1
