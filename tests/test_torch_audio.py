"""The audio tower of rrs_tpu_torch against rrs_tpu: the log-mel front end
and the WAV decoder bit for bit, the Whisper encoder with the qwen2a and
ultravox projectors in f32 on weights carried across, the mmproj writer
byte for byte and its loader, and ``input_audio`` parts on the server
against JAX's server, greedy, with f32 weights and caches."""

import base64
import http.client
import io
import json
import threading
import wave
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from rrs_tpu.mtmd import audio as jaudio
from rrs_tpu.mtmd import pipeline as jpipe
from rrs_tpu_torch.mtmd import audio, pipeline

from test_torch_common import jax_cfg, tiny_vocab_tokens, torch_audio, torch_cfg, weights_tree

ENC_TOL = 1e-5          # f32 both, rel L2


def _tone(seconds: float, sr: int = 16000) -> np.ndarray:
    """A two-tone signal with noise, the clip of tests/test_mtmd_audio.py."""
    t = np.arange(int(seconds * sr)) / sr
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.1 * np.sin(2 * np.pi * 1313 * t)
    return (x + 0.02 * np.random.default_rng(0).standard_normal(t.size)).astype(np.float32)


def _rel_l2(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


# -- the front end ---------------------------------------------------------------

@pytest.mark.parametrize("seconds", [2.0, 30.0, 45.0, 65.0])
@pytest.mark.parametrize("n_mel", [80, 128])
def test_log_mel_and_chunks_bit_equal(seconds, n_mel):
    """Clips shorter than 30 s (padded to 31 s), of 30 s, and longer (one
    and two whole chunks, the partial tail dropped)."""
    x = _tone(seconds)
    fb = audio.mel_filterbank(n_mel, audio.N_FFT, audio.AUDIO_SR)
    np.testing.assert_array_equal(fb, jaudio.mel_filterbank(n_mel, jaudio.N_FFT, jaudio.AUDIO_SR))
    mel = audio.log_mel_spectrogram(x, n_mel=n_mel)
    ref = jaudio.log_mel_spectrogram(x, n_mel=n_mel)
    assert mel.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(mel, ref)
    chunks, jchunks = audio.chunk_mel(mel), jaudio.chunk_mel(ref)
    assert len(chunks) == len(jchunks) == max(1, int(seconds * 100) // 3000)
    for a, b in zip(chunks, jchunks):
        np.testing.assert_array_equal(a, b)


def test_chunking_drops_partial_tail():
    for frames, n in ((2999, 0), (3000, 1), (6500, 2), (9000, 3)):
        mel = np.zeros((80, frames), np.float32)
        assert len(audio.chunk_mel(mel)) == len(jaudio.chunk_mel(mel)) == n


def _wav(pcm: np.ndarray, width: int, sr: int, channels: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


WAV_CASES = {
    "pcm8-mono-16k": (1, 16000, 1),
    "pcm16-mono-16k": (2, 16000, 1),
    "pcm32-mono-16k": (4, 16000, 1),
    "pcm16-stereo-16k": (2, 16000, 2),
    "pcm16-stereo-44k1": (2, 44100, 2),
    "pcm8-mono-22k05": (1, 22050, 1),
}


@pytest.mark.parametrize("case", sorted(WAV_CASES))
def test_decode_audio_b64_bit_equal(case):
    width, sr, ch = WAV_CASES[case]
    rng = np.random.default_rng(width * 7 + ch)
    n = int(0.7 * sr)
    x = np.sin(np.arange(n * ch) / 9.0) * 0.6 + rng.standard_normal(n * ch) * 0.1
    dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
    pcm = (np.clip(x, -1, 1) * (127 if width == 1 else np.iinfo(dtype).max)
           + (128 if width == 1 else 0)).astype(dtype)
    b64 = base64.b64encode(_wav(pcm, width, sr, ch)).decode()
    for data in (b64, "data:audio/wav;base64," + b64):
        got = pipeline.decode_audio_b64(data)
        ref = jpipe.decode_audio_b64(data)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    assert got.size == int(round(n * 16000 / sr))


def test_undecodable_audio_raises_value_error():
    """The port raises ValueError on a payload that ``wave`` cannot read (the
    server answers 400); the JAX package lets ``wave``'s own error out."""
    for bad in ("AA==", base64.b64encode(b"RIFF\x00\x00\x00\x00WAVE").decode()):
        with pytest.raises(ValueError, match="WAV"):
            pipeline.decode_audio_b64(bad)
        with pytest.raises((EOFError, wave.Error)):
            jpipe.decode_audio_b64(bad)


# -- the encoder and the projectors ----------------------------------------------

def _configs():
    """projector -> AudioConfig fields at a small width; the ultravox stack
    factor 16 pads 1,500 rows to 1,504."""
    base = dict(n_mel=80, n_embd=64, n_layers=2, n_heads=4, n_ff=128, n_embd_llm=48)
    return {"qwen2a": dict(base, projector="qwen2a"),
            "ultravox": dict(base, projector="ultravox", stack_factor=16)}


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    """projector -> (JAX (cfg, weights), port (cfg, weights) carried across,
    the file both were read from)."""
    d = tmp_path_factory.mktemp("audio")
    out = {}
    for i, (name, kw) in enumerate(_configs().items()):
        path = jaudio.write_audio_mmproj(d / f"{name}.gguf", jaudio.AudioConfig(**kw), seed=3 + i)
        jc, jw = jaudio.load_audio_mmproj(path)
        out[name] = ((jc, jw), torch_audio(jc, jw), path)
    return out


@pytest.mark.parametrize("projector", ["qwen2a", "ultravox"])
def test_encoder_forward_matches_jax(towers, projector):
    (jc, jw), (c, w), _ = towers[projector]
    mel = audio.chunk_mel(audio.log_mel_spectrogram(_tone(2.0), n_mel=80))[0]
    got = audio.encoder_forward(c, w, mel)
    with jax.disable_jit():
        ref = np.asarray(jaudio.encoder_forward(jc, jw, mel))
    rows = 1500 if projector == "qwen2a" else 94
    assert got.shape == ref.shape == (rows, 48) and got.dtype == torch.float32
    assert _rel_l2(got.numpy(), ref) <= ENC_TOL


@pytest.mark.parametrize("projector", ["qwen2a", "ultravox"])
def test_embed_audio_matches_jax(towers, projector):
    """End to end from PCM, a 65 s clip: two chunks."""
    (jc, jw), (c, w), _ = towers[projector]
    x = _tone(65.0)
    got = audio.embed_audio(c, w, x)
    with jax.disable_jit():
        ref = jaudio.embed_audio(jc, jw, x)
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        assert _rel_l2(a.numpy(), b) <= ENC_TOL


def test_unknown_projector_raises(towers):
    (_, _), (c, w), _ = towers["qwen2a"]
    c = audio.AudioConfig(**{**c.__dict__, "projector": "nope"})
    with pytest.raises(ValueError, match="unknown audio projector"):
        audio.encoder_forward(c, w, np.zeros((80, 3000), np.float32))


@pytest.mark.parametrize("projector", ["qwen2a", "ultravox"])
def test_mmproj_writer_byte_equal_and_loader(towers, tmp_path, projector):
    (jc, jw), (c, w), path = towers[projector]
    i = list(_configs()).index(projector)
    mine = audio.write_audio_mmproj(tmp_path / "port.gguf",
                                    audio.AudioConfig(**_configs()[projector]), seed=3 + i)
    assert mine.read_bytes() == path.read_bytes()
    cfg, weights = audio.load_audio_mmproj(path, device="cpu")
    assert cfg == c
    for a, b in zip([weights, *weights.layers], [w, *w.layers]):
        for f in a.__dataclass_fields__:
            if isinstance(getattr(a, f), torch.Tensor):
                assert getattr(a, f).is_contiguous()
                torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=0, atol=0)
    assert weights.proj.keys() == w.proj.keys()
    for k in w.proj:
        torch.testing.assert_close(weights.proj[k], w.proj[k], rtol=0, atol=0)
    assert weights.nbytes() == sum(np.asarray(a).nbytes for a in jax.tree_util.tree_leaves(jw))


def test_loader_defaults_to_cuda(towers):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        audio.load_audio_mmproj(towers["qwen2a"][2])


# -- the server --------------------------------------------------------------------

def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, json.loads(data)


def test_server_audio_parts_match_jax(towers):
    """The chat of tests/test_mtmd_audio.py: text and a 1 s PCM16 WAV part,
    with the ultravox tower loaded (stack 16: 94 audio rows) on a 2-layer f32
    model: the port answers JAX's greedy text and counts JAX's prompt rows.
    Before the tower is loaded, ``/apply-template``, ``/v1/messages`` and the
    chat route take the audio part as JAX's do (to the template, as text);
    with it, a WAV that cannot be decoded answers 400."""
    from rrs_tpu.models.llama import random_weights as jrandom
    from rrs_tpu.models.vocab import Vocab as JaxVocab
    from rrs_tpu.runtime.context import InferenceContext as JaxContext
    from rrs_tpu.serving import server as jserver
    from rrs_tpu.serving.engine import Engine as JaxEngine
    from rrs_tpu_torch.models.llama import weights_from_numpy
    from rrs_tpu_torch.models.vocab import Vocab
    from rrs_tpu_torch.runtime.context import InferenceContext
    from rrs_tpu_torch.serving import server
    from rrs_tpu_torch.serving.engine import Engine

    jlm = jax_cfg(n_embd=48, n_heads=4, n_kv_heads=2, head_dim=16, n_ff=128, vocab_size=300,
                  context_length=256)
    lm = torch_cfg(jlm)
    jw = jrandom(jlm, seed=0, dtype=np.float32)
    w = weights_from_numpy(lm, weights_tree(jw), device="cpu")
    toks = tiny_vocab_tokens(lm.vocab_size)
    kw = dict(model="gpt2", tokens=toks, scores=None, token_types=[1] * len(toks), merges=[],
              pre="gpt-2", bos_id=0, eos_id=1, add_bos=False)
    eng = Engine(InferenceContext(lm, w, n_lanes=2, max_seq=256, kv_dtype=torch.float32,
                                  device="cpu"))
    eng.start()
    st = server.ServerState(lm, Vocab(**kw), eng, {}, "tiny-audio")
    jeng = JaxEngine(JaxContext(jlm, jw, n_lanes=2, max_seq=256, kv_dtype=np.float32))
    jst = jserver.ServerState(jlm, JaxVocab(**kw), jeng, {}, "tiny-audio")
    httpds = [ThreadingHTTPServer(("127.0.0.1", 0), mod.make_handler(s))
              for mod, s in ((server, st), (jserver, jst))]
    for h in httpds:
        threading.Thread(target=h.serve_forever, daemon=True).start()
    port, jport = (h.server_address[1] for h in httpds)

    def both(path, body):
        box = {}
        t = threading.Thread(target=lambda: box.update(r=_post(jport, path, body)))
        t.start()
        with jax.disable_jit():
            while t.is_alive():
                jeng._iterate()
        t.join()
        return _post(port, path, body), box["r"]

    pcm = (np.sin(np.arange(16000) / 10.0) * 8000).astype(np.int16)
    b64 = base64.b64encode(_wav(pcm, 2, 16000, 1)).decode()
    content = [{"type": "text", "text": "what is this sound? "},
               {"type": "input_audio", "input_audio": {"data": b64, "format": "wav"}},
               {"type": "text", "text": " tell"}]
    chat = {"messages": [{"role": "user", "content": content}], "max_tokens": 5,
            "temperature": 0}
    try:
        (s1, out), (s2, ref) = both("/apply-template", chat)
        assert s1 == s2 == 200 and out["prompt"] == ref["prompt"]
        (s1, out), (s2, ref) = both("/v1/messages", chat)
        assert s1 == s2 == 200
        # JAX counts its output pieces, the final empty one too; the port the tokens
        assert out["content"] == ref["content"]
        assert out["usage"]["input_tokens"] == ref["usage"]["input_tokens"]
        (s1, out), (s2, ref) = both("/v1/chat/completions", chat)
        assert s1 == s2 == 200
        assert out["choices"][0]["message"] == ref["choices"][0]["message"]
        st.audio_cfg, st.audio_weights = towers["ultravox"][1]
        jst.audio_cfg, jst.audio_weights = towers["ultravox"][0]
        n0, jn0 = eng.n_prompt_tokens, jeng.n_prompt_tokens
        (s1, out), (s2, ref) = both("/v1/chat/completions", chat)
        assert s1 == s2 == 200, (out, ref)
        assert out["choices"][0]["message"] == ref["choices"][0]["message"]
        assert out["usage"]["completion_tokens"] == 5
        assert eng.n_prompt_tokens - n0 == jeng.n_prompt_tokens - jn0 > 94
        bad = json.loads(json.dumps(chat))
        bad["messages"][0]["content"][1]["input_audio"]["data"] = "AA=="
        status, out = _post(port, "/v1/chat/completions", bad)
        assert status == 400 and "WAV" in out["error"]
    finally:
        for h in httpds:
            h.shutdown()
            h.server_close()
        eng.stop()
