"""The multimodal front end of rrs_tpu_torch against rrs_tpu and Pillow: the
port's PNG decoder and bicubic resize against Pillow, byte for byte (the
JAX package decodes and resizes with Pillow, which the card's machine does
not have); the preprocessors against JAX's on the same decoded image;
``generate_with_images`` against JAX's; and a tiny Qwen2-VL served with its
tower: the engine's image segments and the server's ``image_url`` parts
against JAX's engine and server, greedy, with f32 weights and caches."""

import base64
import io
import struct
import sys
import zlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from rrs_tpu_torch.mtmd import image_io

from test_torch_common import jax_cfg, rel_err, torch_cfg, torch_clip, weights_tree

transformers = pytest.importorskip("transformers")


def _smooth(rng, h, w):
    img = np.cumsum(rng.integers(-9, 10, (h, w, 3)), axis=1) + rng.integers(0, 256, (h, 1, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _png(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


# Pillow-written PNGs: every 8-bit color type, adaptive and fixed row filters,
# and the packed 1 / 2 / 4-bit greyscale and palette images
PNG_CASES = {
    "rgb": lambda im: _png(im),
    "rgb-optimize": lambda im: _png(im, optimize=True),
    "rgb-fast": lambda im: _png(im, compress_level=1),
    "rgba": lambda im: _png(im.convert("RGBA")),
    "grey": lambda im: _png(im.convert("L")),
    "grey-alpha": lambda im: _png(im.convert("LA")),
    "palette": lambda im: _png(im.quantize(64)),
    "palette-4bit": lambda im: _png(im.quantize(16), optimize=True),
    "palette-2bit": lambda im: _png(im.quantize(4), bits=2),
    "bilevel": lambda im: _png(im.convert("1")),
}


@pytest.mark.parametrize("case", sorted(PNG_CASES))
def test_png_decode_matches_pillow(case):
    """Every case decodes to Pillow's ``convert("RGB")`` bytes."""
    data = PNG_CASES[case](Image.fromarray(_smooth(np.random.default_rng(1), 37, 53)))
    got = image_io.decode_image(data)
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


# (source h, w) -> (target h, w): down- and upscales on each axis, one axis
# alone, a no-op, the qwen2vl sizes of the smoke run's images
RESIZE_CASES = [((50, 70), (28, 28)), ((64, 64), (448, 448)), ((100, 37), (56, 84)),
                ((30, 40), (30, 56)), ((17, 23), (9, 5)), ((200, 300), (112, 112)),
                ((33, 33), (33, 33)), ((440, 440), (448, 448)), ((450, 660), (448, 672))]


@pytest.mark.parametrize("src,dst", RESIZE_CASES, ids=[f"{s}->{d}" for s, d in RESIZE_CASES])
def test_bicubic_resize_matches_pillow(src, dst):
    """Noise and a smooth image, resized bit-equal to Pillow's BICUBIC."""
    rng = np.random.default_rng(src[0] * 1000 + dst[1])
    for img in (rng.integers(0, 256, src + (3,), dtype=np.uint8), _smooth(rng, *src)):
        ref = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.BICUBIC))
        np.testing.assert_array_equal(image_io.resize_bicubic(img, dst[1], dst[0]), ref)


def test_png_writer_and_refusals(monkeypatch):
    """The port's own PNG writer reads back; a corrupt chunk, an interlaced
    image and a 16-bit image raise ValueError; JPEG goes through Pillow where
    it can be imported and, where it cannot, raises a ValueError naming the
    format and the missing decoder."""
    img = _smooth(np.random.default_rng(2), 21, 34)
    data = image_io.encode_png(img)
    np.testing.assert_array_equal(image_io.decode_image(data), img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    bad = bytearray(data)
    bad[40] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        image_io.decode_image(bytes(bad))
    ihdr = struct.pack(">IIBBBBB", 34, 21, 8, 2, 0, 0, 1)        # the interlace flag set
    chunk = b"IHDR" + ihdr
    laced = data[:8] + struct.pack(">I", 13) + chunk + struct.pack(">I", zlib.crc32(chunk)) \
        + data[33:]
    with pytest.raises(ValueError, match="interlaced"):
        image_io.decode_image(laced)
    with pytest.raises(ValueError, match="bit depth 16"):
        image_io.decode_image(_png(Image.fromarray(img[..., 0].astype(np.uint16) * 257)))
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    jpeg = buf.getvalue()
    np.testing.assert_array_equal(image_io.decode_image(jpeg),
                                  np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB")))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="jpeg image.*Pillow"):
        image_io.decode_image(jpeg)
    np.testing.assert_array_equal(image_io.decode_image(data), img)


def test_preprocess_matches_jax():
    """The same PNG through each package's decoder and preprocessor: the
    square CLIP input (a 40 x 50 image resized to 28 x 28) and the qwen2vl
    dynamic resolution (13 x 22 -> 16 x 24) give equal patches."""
    from rrs_tpu.mtmd import clip as jclip
    from rrs_tpu_torch.mtmd import clip

    rng = np.random.default_rng(3)
    for (h, w), kw in (((40, 50), dict(image_size=28, patch_size=14)),
                       ((13, 22), dict(patch_size=4, projector_type="qwen2vl_merger"))):
        data = image_io.encode_png(_smooth(rng, h, w))
        jcfg, cfg = jclip.ClipConfig(**kw), clip.ClipConfig(**kw)
        pil, arr = Image.open(io.BytesIO(data)), image_io.decode_image(data)
        if "projector_type" in kw:
            (got, ggrid), (ref, rgrid) = (clip.preprocess_image_qwen2vl(arr, cfg),
                                          jclip.preprocess_image_qwen2vl(pil, jcfg))
            assert ggrid == rgrid == (4, 6)
        else:
            got, ref = clip.preprocess_image(arr, cfg), jclip.preprocess_image(pil, jcfg)
        np.testing.assert_array_equal(got, ref)


class CharVocab:
    def encode(self, text, add_special=False):
        return [min(ord(c), 95) for c in text]


def test_generate_with_images_matches_jax():
    """The case of tests/test_mtmd.py: a 2-layer qwen3 fed through two image
    markers by the LLaVA mlp tower, f32 weights carried across from the JAX
    package's; the chunks within 1e-5 of JAX's, the greedy tokens equal; a
    marker count that does not match the images raises."""
    from rrs_tpu.models.llama import random_weights as jrandom
    from rrs_tpu.mtmd import clip as jclip
    from rrs_tpu.mtmd import pipeline as jpipe
    from rrs_tpu.runtime.context import InferenceContext as JaxContext
    from rrs_tpu_torch.models.llama import weights_from_numpy
    from rrs_tpu_torch.mtmd import pipeline
    from rrs_tpu_torch.runtime.context import InferenceContext

    jlm = jax_cfg(n_embd=128, n_heads=4, n_kv_heads=2, head_dim=32, n_ff=256, vocab_size=96,
                  context_length=128)
    lm = torch_cfg(jlm)
    jw = jrandom(jlm, seed=0, dtype=np.float32)
    w = weights_from_numpy(lm, weights_tree(jw), device="cpu")
    jccfg = jclip.ClipConfig(image_size=28, patch_size=14, n_embd=64, n_layers=2, n_heads=4,
                             n_ff=128, n_embd_llm=lm.n_embd)
    jcw = jclip.random_clip_weights(jccfg, seed=1)
    ccfg, cw = torch_clip(jccfg, jcw)
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, (28, 28, 3)).astype(np.uint8) for _ in range(2)]
    prompt = f"look: {pipeline.IMAGE_MARKER} and {pipeline.IMAGE_MARKER} what?"
    chunks = pipeline.embed_images(ccfg, cw, imgs)
    with jax.disable_jit():
        jchunks = jpipe.embed_images(jccfg, jcw, imgs)
    for a, b in zip(chunks, jchunks):
        assert rel_err(a.numpy(), b) <= 1e-5
    got = pipeline.generate_with_images(
        InferenceContext(lm, w, n_lanes=1, max_seq=128, kv_dtype=torch.float32, device="cpu"),
        CharVocab(), prompt, imgs, ccfg, cw, max_new_tokens=6)
    with jax.disable_jit():
        ref = jpipe.generate_with_images(
            JaxContext(jlm, jw, n_lanes=1, max_seq=128, kv_dtype=np.float32), CharVocab(),
            prompt, imgs, jccfg, jcw, max_new_tokens=6)
    assert got == ref and len(got) == 6
    ctx = InferenceContext(lm, w, n_lanes=1, max_seq=128, device="cpu")
    with pytest.raises(ValueError, match="image markers"):
        pipeline.multimodal_prefill(ctx, CharVocab(), ctx.new_sequence(), prompt, chunks[:1])


# -- a tiny Qwen2-VL, served ---------------------------------------------------

@pytest.fixture(scope="module")
def vlm(tmp_path_factory):
    """The tiny Qwen2-VL converted by the port (model and mmproj), loaded in
    f32 by both packages."""
    from rrs_tpu.models.loader import load_model as jload
    from rrs_tpu.mtmd.clip import load_mmproj as jload_mmproj
    from rrs_tpu_torch.models.loader import load_model
    from rrs_tpu_torch.mtmd.clip import load_mmproj
    from rrs_tpu_torch.tools.convert_hf import convert_hf_mmproj, convert_hf_to_gguf

    from test_torch_qwen2vl import tiny_qwen2vl

    d = tmp_path_factory.mktemp("vlm")
    hf = tiny_qwen2vl(d / "hf")
    model = convert_hf_to_gguf(hf, d / "model.gguf")
    mm = convert_hf_mmproj(hf, d / "mmproj.gguf")
    cfg, w, md = load_model(model, dtype=torch.float32, device="cpu", fuse=False)
    jcfg, jw, jmd = jload(model, dtype=np.float32, fuse=False)
    return dict(cfg=cfg, w=w, md=md, jcfg=jcfg, jw=jw, jmd=jmd, mmproj=mm,
                clip=load_mmproj(mm, device="cpu"), jclip=jload_mmproj(mm))


def _drive(eng, req, jax_engine=False):
    out, done = [], {}
    req.on_token = lambda t, pc, f, r: done.__setitem__("r", r) if f else out.append(t)
    eng.submit(req)
    for _ in range(200):
        if jax_engine:
            with jax.disable_jit():
                eng._iterate()
        else:
            eng._iterate()
        if done:
            break
    return out, done.get("r")


def test_engine_image_segments_match_jax(vlm):
    """[tokens, a Qwen2-VL image chunk with its grid, tokens]: the port's
    engine gives JAX's greedy tokens, decoding step by step once the lane has
    an M-RoPE delta, and frees the lane. A request whose rows (tokens and
    image rows) fill the context is refused as too long: the port counts an
    image chunk's rows, where JAX's engine counts an M-RoPE segment as 2."""
    from rrs_tpu.runtime.context import InferenceContext as JaxContext
    from rrs_tpu.serving.engine import Engine as JaxEngine
    from rrs_tpu.runtime.sampler import SamplerParams as JaxParams
    from rrs_tpu.serving.engine import GenRequest as JaxRequest
    from rrs_tpu_torch.mtmd.pipeline import embed_images
    from rrs_tpu_torch.runtime.context import InferenceContext
    from rrs_tpu_torch.runtime.sampler import SamplerParams
    from rrs_tpu_torch.serving.engine import Engine, GenRequest

    img = _smooth(np.random.default_rng(4), 16, 24)
    (chunk, grid), = embed_images(*vlm["clip"], [img])
    ctx = InferenceContext(vlm["cfg"], vlm["w"], n_lanes=2, max_seq=64, kv_dtype=torch.float32,
                           device="cpu")
    jctx = JaxContext(vlm["jcfg"], vlm["jw"], n_lanes=2, max_seq=64, kv_dtype=np.float32)
    eng, jeng = Engine(ctx), JaxEngine(jctx)
    segs = [("tokens", [3, 17, 42, 100]), ("embeds_mrope", (chunk, grid)), ("tokens", [5, 99])]
    jsegs = [("tokens", [3, 17, 42, 100]), ("embeds_mrope", (chunk.numpy(), grid)),
             ("tokens", [5, 99])]
    got, r = _drive(eng, GenRequest(prompt_tokens=[], max_tokens=8, segments=segs,
                                    params=SamplerParams(temperature=0.0)))
    ref, jr = _drive(jeng, JaxRequest(prompt_tokens=[], max_tokens=8, segments=jsegs,
                                      params=JaxParams(temperature=0.0)), jax_engine=True)
    assert got == ref and r == jr == "length" and len(got) == 8
    assert eng.n_prompt_tokens == jeng.n_prompt_tokens == 12
    assert eng.n_decode_runs == 0 and all(s is None for s in ctx.kv.seq_ids)
    long = [("tokens", list(range(3, 61))), ("embeds_mrope", (chunk, grid))]
    _, r = _drive(eng, GenRequest(prompt_tokens=[], max_tokens=2, segments=long))
    assert r.startswith("error: prompt too long (64 tokens")


def _req(port, body):
    import http.client
    import json

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/v1/chat/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, json.loads(data)


def test_server_image_parts_match_jax(vlm):
    """A chat request with text and an ``image_url`` PNG data URL, served
    with the tower loaded (``--mmproj``): the port's server answers JAX's
    greedy text. An image the port cannot decode answers 400; an audio part,
    with no audio tower loaded, reaches the chat template as in JAX's server
    and gets JAX's answer."""
    import json
    import threading
    from http.server import ThreadingHTTPServer

    from rrs_tpu.runtime.context import InferenceContext as JaxContext
    from rrs_tpu.serving import server as jserver
    from rrs_tpu.serving.engine import Engine as JaxEngine
    from rrs_tpu_torch.models.vocab import Vocab
    from rrs_tpu_torch.runtime.context import InferenceContext
    from rrs_tpu_torch.serving import server
    from rrs_tpu_torch.serving.engine import Engine

    from rrs_tpu.models.vocab import Vocab as JaxVocab
    from test_torch_common import tiny_vocab_tokens

    toks = tiny_vocab_tokens(vlm["cfg"].vocab_size)
    kw = dict(model="gpt2", tokens=toks, scores=None, token_types=[1] * len(toks), merges=[],
              pre="gpt-2", bos_id=0, eos_id=1, add_bos=False)
    ctx = InferenceContext(vlm["cfg"], vlm["w"], n_lanes=2, max_seq=96, kv_dtype=torch.float32,
                           device="cpu")
    eng = Engine(ctx)
    eng.start()
    st = server.ServerState(vlm["cfg"], Vocab(**kw), eng, {}, "tiny-vl")
    st.clip_cfg, st.clip_weights = vlm["clip"]
    jctx = JaxContext(vlm["jcfg"], vlm["jw"], n_lanes=2, max_seq=96, kv_dtype=np.float32)
    jeng = JaxEngine(jctx)
    jst = jserver.ServerState(vlm["jcfg"], JaxVocab(**kw), jeng, {}, "tiny-vl")
    jst.clip_cfg, jst.clip_weights = vlm["jclip"]
    httpds = [ThreadingHTTPServer(("127.0.0.1", 0), mod.make_handler(s))
              for mod, s in ((server, st), (jserver, jst))]
    for h in httpds:
        threading.Thread(target=h.serve_forever, daemon=True).start()
    port, jport = (h.server_address[1] for h in httpds)
    url = "data:image/png;base64," + base64.b64encode(
        image_io.encode_png(_smooth(np.random.default_rng(5), 15, 26))).decode()
    body = {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "see "}, {"type": "image_url", "image_url": {"url": url}},
        {"type": "text", "text": " ok"}]}], "max_tokens": 6, "temperature": 0}
    try:
        status, out = _req(port, body)
        box = {}
        t = threading.Thread(target=lambda: box.update(r=_req(jport, body)))
        t.start()
        with jax.disable_jit():
            while t.is_alive():
                jeng._iterate()
        t.join()
        jstatus, jout = box["r"]
        assert status == jstatus == 200, (out, jout)
        assert out["choices"][0]["message"]["content"] == jout["choices"][0]["message"]["content"]
        assert out["usage"]["completion_tokens"] == 6
        bad = json.loads(json.dumps(body))
        bad["messages"][0]["content"][1]["image_url"]["url"] = "data:image/png;base64,AA=="
        status, out = _req(port, bad)
        assert status == 400 and "error" in out
        audio = {"messages": [{"role": "user", "content": [
            {"type": "text", "text": "hear "},
            {"type": "input_audio", "input_audio": {"data": "AA==", "format": "wav"}}]}],
            "max_tokens": 4, "temperature": 0}
        status, out = _req(port, audio)
        t = threading.Thread(target=lambda: box.update(r=_req(jport, audio)))
        t.start()
        with jax.disable_jit():
            while t.is_alive():
                jeng._iterate()
        t.join()
        jstatus, jout = box["r"]
        assert status == jstatus == 200, (out, jout)
        assert out["choices"][0]["message"] == jout["choices"][0]["message"]
    finally:
        for h in httpds:
            h.shutdown()
            h.server_close()
        eng.stop()


def test_audio_tower_refused(vlm, tmp_path):
    """``serve --mmproj`` loads each tower its file holds, as JAX's server
    does: an audio-only file its audio tower, the tiny Qwen2-VL's file its
    vision tower, a file holding both (the vision file with an audio tower
    added) both, each as JAX's loaders read it; a file with no tower at all
    is refused (JAX's server loads nothing and serves on)."""
    from rrs_tpu.gguf.reader import read_gguf as jread
    from rrs_tpu.mtmd import audio as jaudio
    from rrs_tpu.mtmd.clip import load_mmproj as jload_mmproj
    from rrs_tpu_torch.gguf.writer import GGUFWriter
    from rrs_tpu_torch.mtmd import audio
    from rrs_tpu_torch.serving.server import load_towers

    from test_torch_common import rewrite_gguf, torch_audio

    acfg = audio.AudioConfig(n_mel=80, n_embd=64, n_layers=1, n_heads=4, n_ff=128,
                             n_embd_llm=64, projector="ultravox", stack_factor=32)
    apath = audio.write_audio_mmproj(tmp_path / "audio.gguf", acfg, seed=2)
    w = GGUFWriter(tmp_path / "none.gguf")
    w.add_string("general.architecture", "clip")
    w.add_tensor("x.weight", np.zeros((4, 4), np.float32))
    w.write()
    vpath = vlm["mmproj"]
    with jread(apath) as g:
        akv = {k: v for k, v in g.metadata.items() if k.startswith("clip.audio.")}
        atensors = {n: np.array(g.tensor(n), np.float32) for n in g.tensors}
    both = rewrite_gguf(vpath, tmp_path / "both.gguf", kv=akv,
                        edit=lambda name, arr: atensors if name == "" else {name: arr})
    clip, aud = load_towers(str(apath), device="cpu")
    assert clip is None and aud[0] == torch_audio(*jaudio.load_audio_mmproj(apath))[0]
    assert aud[0].projector == "ultravox" and len(aud[1].layers) == 1
    clip, aud = load_towers(str(vpath), device="cpu")
    assert aud is None and clip[0] == vlm["clip"][0]
    clip, aud = load_towers(str(both), device="cpu")
    assert clip[0] == vlm["clip"][0] and len(clip[1].layers) == len(vlm["clip"][1].layers)
    ref = torch_audio(*jaudio.load_audio_mmproj(both))
    assert aud[0] == ref[0] and aud[0].projector == jload_mmproj(both)[0].projector_type
    for a, b in zip([aud[1], *aud[1].layers], [ref[1], *ref[1].layers]):
        for f in a.__dataclass_fields__:
            if isinstance(getattr(a, f), torch.Tensor):
                assert torch.equal(getattr(a, f), getattr(b, f)), f
    with pytest.raises(ValueError, match="no vision .* or audio .* tower"):
        load_towers(str(tmp_path / "none.gguf"), device="cpu")
