"""The port's native host codec (``rrs_tpu_torch/csrc/rrs_core.cpp`` through
``rrs_tpu_torch/native.py``) against the JAX package's build of its own copy
(``rrs_tpu/_rrs_core.so``) and against each package's NumPy paths.

* ``tcq4_quantize`` and ``dequant`` give JAX's native bytes and bits.
* ``tcq4_decode_tiles`` gives the NumPy tile decode's codes and f32 eff, so
  the loader's bf16 eff is the same bits either way (the JAX loader keeps the
  native eff in f32: ROADMAP queue C).
* The TCQ4 NumPy fallback runs its FWHT in f64 and can round a tile
  differently from the native f32 one: the tiles that differ are counted
  (queue C), and each differs by at most one code step.
* ``bpe_encode`` gives JAX's native ids and the Python merge loop's.

Everything here skips only where ``g++`` is absent.
"""

import shutil
from unittest import mock

import numpy as np
import pytest

from rrs_tpu import native as jax_native
from rrs_tpu.formats import kquants as jax_kquants
from rrs_tpu.formats.tcq4 import quantize_tcq4 as jax_quantize_tcq4
from rrs_tpu.formats.tile_codec import encode_tcq4_gguf as jax_encode_tcq4
from rrs_tpu.models.vocab import Vocab as JaxVocab
from rrs_tpu_torch import native
from rrs_tpu_torch.formats import kquants
from rrs_tpu_torch.formats.fwht import fwht_np
from rrs_tpu_torch.formats.tcq4 import effective_scales, quantize_tcq4, unpack_nibbles
from rrs_tpu_torch.formats.tile_codec import decode_tcq4_gguf, encode_tcq4_gguf
from rrs_tpu_torch.models.vocab import Vocab, _byte_encoder

import test_torch_common  # noqa: F401  (one torch thread per worker)


@pytest.fixture()
def both_built():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native host codecs cannot build")
    assert native.available(), "the port's native host codec did not build"
    assert jax_native.available()


def _weights(rng, n, k, outliers=True):
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    if outliers:
        w[rng.integers(0, n, 6), rng.integers(0, k, 6)] *= 30.0
        w[0, :256] = 0.0                      # an all-zero superblock
    return w


def test_library_builds_into_build_dir(both_built):
    path = native.library_path()
    assert path.exists() and path.parent.name == "build"
    assert path.name.startswith("librrs_core_") and path.suffix == ".so"


@pytest.mark.parametrize("n,k", [(8, 256), (64, 768), (40, 1024)])
def test_tcq4_quantize_matches_jax_native(both_built, n, k):
    w = _weights(np.random.default_rng(n + k), n, k)
    q, s, big_s = native.tcq4_quantize(w)
    jq, js, jbig = jax_native.tcq4_quantize(w)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(big_s.view(np.uint16), jbig.view(np.uint16))
    perm = np.concatenate([b * 256 + np.random.default_rng(k).permutation(256)
                           for b in range(k // 256)])
    t, jt = quantize_tcq4(w, perm=perm), jax_quantize_tcq4(w, perm=perm)
    assert encode_tcq4_gguf(t) == bytes(jax_encode_tcq4(jt))
    np.testing.assert_array_equal(t.perm, jt.perm)


@pytest.mark.parametrize("n,k", [(64, 768), (2048, 4096)])
def test_tcq4_numpy_fallback_tiles_that_differ(both_built, n, k):
    """The f64 NumPy FWHT against the native f32 one: the tiles (8 channels
    x 256) whose bytes differ are counted; a differing code moves by one step
    (a value on a rounding boundary), and no scale code moves by more."""
    w = _weights(np.random.default_rng(3), n, k, outliers=False)
    nat = quantize_tcq4(w)
    ref = quantize_tcq4(w, use_native=False)
    jref = jax_quantize_tcq4(w, use_native=False)
    assert encode_tcq4_gguf(ref) == bytes(jax_encode_tcq4(jref))
    a = np.frombuffer(encode_tcq4_gguf(nat), np.uint8).reshape(-1, 1184)
    b = np.frombuffer(encode_tcq4_gguf(ref), np.uint8).reshape(-1, 1184)
    differ = int((a != b).any(axis=1).sum())
    print(f"\n[{n}, {k}]: {differ} of {a.shape[0]} TCQ4 tiles differ between the native "
          f"(f32 FWHT) and NumPy (f64 FWHT) encoders")
    assert differ <= a.shape[0] // 10
    dq = np.abs(unpack_nibbles(nat.qs).astype(int) - unpack_nibbles(ref.qs).astype(int))
    assert dq.max() <= 1
    assert np.abs(nat.sc.astype(int) - ref.sc.astype(int)).max() <= 1


@pytest.mark.parametrize("n,k", [(16, 512), (48, 256)])
def test_tcq4_decode_tiles_matches_numpy_and_jax(both_built, n, k):
    w = _weights(np.random.default_rng(k), n, k)
    raw = np.frombuffer(encode_tcq4_gguf(quantize_tcq4(w)), np.uint8)
    qs, eff = native.tcq4_decode_tiles(raw, n, k)
    jqs, jeff = jax_native.tcq4_decode_tiles(raw, n, k)
    np.testing.assert_array_equal(qs, jqs)
    np.testing.assert_array_equal(eff.view(np.uint32), jeff.view(np.uint32))
    t = decode_tcq4_gguf(raw, (n, k))
    np.testing.assert_array_equal(qs, t.qs)
    ref = effective_scales(t).astype(np.float32)
    np.testing.assert_array_equal(eff.view(np.uint32), ref.view(np.uint32))
    import torch

    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).view(torch.int16)   # noqa: E731
    assert torch.equal(bf(eff), bf(ref))


@pytest.mark.parametrize("kind", ["q8_0", "q4_k", "q6_k"])
def test_dequant_matches_jax_and_numpy(both_built, kind):
    rng = np.random.default_rng(11)
    x = _weights(rng, 8, 512)
    raw = np.asarray(getattr(jax_kquants, f"quantize_{kind}")(x), np.uint8).reshape(-1)
    got = native.dequant(raw, kind, x.size)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  jax_native.dequant(raw, kind, x.size).view(np.uint32))
    ref = getattr(kquants, f"dequantize_{kind}")(raw, x.size).astype(np.float32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_fwht_rows_matches_jax_and_f64(both_built):
    x = np.random.default_rng(2).standard_normal((12, 256)).astype(np.float32)
    a, b = native.fwht_rows(x.copy()), jax_native.fwht_rows(x.copy())
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, fwht_np(x), rtol=0, atol=1e-5)


def _bpe_metadata():
    byte_syms = list(_byte_encoder().values())
    merges = ["h e", "l l", "Ġ w", "o r", "he ll", "Ġw or", "hell o", "Ġwor l", "Ġworl d",
              "Ġ t", "Ġt he", "i n", "Ġ in"]
    tokens = byte_syms + [m.replace(" ", "") for m in merges]
    return {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": "qwen2",
            "tokenizer.ggml.tokens": tokens, "tokenizer.ggml.merges": merges}


def test_bpe_native_matches_python_and_jax(both_built):
    md = _bpe_metadata()
    text = "hello world, the inn in hell; héllo 123 worlds\n\tthe end"
    port = Vocab.from_gguf(md)
    assert port._native_bpe_handle() is not None
    ids = port.encode(text, add_special=False)
    assert ids == JaxVocab.from_gguf(md).encode(text, add_special=False)
    with mock.patch.object(native, "available", lambda: False), \
            mock.patch.object(native, "_load", lambda: None):
        py = Vocab.from_gguf(md)
        assert py._native_bpe_handle() is None
        assert py.encode(text, add_special=False) == ids
    assert len(ids) < len(text.encode())          # the merges ran
