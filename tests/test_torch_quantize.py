"""The port's ``quantize`` (``rrs_tpu_torch/quantize/quantizer.py`` on its own
codecs) against the JAX package's: on a tiny exported model (the 2-layer
model of tests/test_torch_common.py, F16 as the card phase writes it), the
output GGUF is JAX's byte for byte (so every tensor's type, shape and bytes,
and every metadata key, type and value, ``tcq4.*.perm`` arrays included), for
TCQ4 without and with imatrix permutations, with ``search``, through the
native and the NumPy encoders, and for each of the 20 ftypes of the K-quant
menu without and with an imatrix. The ``quantize`` verb writes the same file.

The imatrix is a file of random positive sums written by JAX's
``save_imatrix``; both packages load it with their own ``load_imatrix``.
"""

import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

from rrs_tpu import native as jax_native
from rrs_tpu.gguf.reader import read_gguf as jax_read_gguf
from rrs_tpu.models.export import export_random_gguf
from rrs_tpu.quantize import imatrix as jax_imatrix
from rrs_tpu.quantize import quantizer as jax_quantizer
from rrs_tpu_torch import native
from rrs_tpu_torch.quantize import imatrix, quantizer

from test_torch_common import jax_cfg, tiny_vocab_tokens

ROOT = Path(__file__).resolve().parent.parent
FTYPES = list(jax_quantizer._OUT_TYPES)


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_quantize")
    path = d / "f16.gguf"
    export_random_gguf(jax_cfg(), path, seed=2, dtype=np.float16,
                       vocab_tokens=tiny_vocab_tokens(256))
    g = jax_read_gguf(path)
    rng = np.random.default_rng(3)
    acc = {n: ((rng.random(info.shape[-1]) * 3 + 0.01).astype(np.float32), 64)
           for n, info in g.tensors.items() if len(info.shape) == 2}
    g.close()
    jax_imatrix.save_imatrix(d / "imatrix.gguf", acc)
    return path


def _check_same(port: Path, jax: Path):
    """The two outputs, equal; a structured diff first for a readable failure."""
    a, b = jax_read_gguf(port), jax_read_gguf(jax)
    try:
        assert list(a.metadata) == list(b.metadata)
        for k in b.metadata:
            assert a.metadata_types.get(k) == b.metadata_types.get(k), k
            assert np.array_equal(np.asarray(a.metadata[k]), np.asarray(b.metadata[k])), k
        assert list(a.tensors) == list(b.tensors)
        for n, info in b.tensors.items():
            assert (a.tensors[n].ggml_type, a.tensors[n].shape) == (info.ggml_type, info.shape), n
            assert np.array_equal(a.tensor_bytes(n), b.tensor_bytes(n)), n
    finally:
        a.close()
        b.close()
    assert port.read_bytes() == jax.read_bytes()


def _both(src, tmp_path, out_type, with_imatrix, **kw):
    im_path = src.parent / "imatrix.gguf"
    perms = jperms = im = jim = None
    if with_imatrix:
        im, jim = imatrix.load_imatrix(im_path), jax_imatrix.load_imatrix(im_path)
        assert sorted(im) == sorted(jim) and all(np.array_equal(im[k], jim[k]) for k in im)
        if out_type == "tcq4":
            perms, jperms = imatrix.derive_tcq4_perms(im), jax_imatrix.derive_tcq4_perms(jim)
            assert all(np.array_equal(perms[k], jperms[k]) for k in jperms) and perms
    stats = quantizer.quantize_model(src, tmp_path / "port.gguf", perms=perms, verbose=False,
                                     out_type=out_type, imatrix=im, **kw)
    jstats = jax_quantizer.quantize_model(src, tmp_path / "jax.gguf", perms=jperms,
                                          verbose=False, out_type=out_type, imatrix=jim, **kw)
    assert stats == jstats
    _check_same(tmp_path / "port.gguf", tmp_path / "jax.gguf")
    return stats


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("with_imatrix", [False, True], ids=["plain", "imatrix-perms"])
def test_tcq4_matches_jax(src, tmp_path, route, with_imatrix):
    if route == "native":
        if not (native.available() and jax_native.available()):
            pytest.skip("a native host codec did not build (no g++)")
        stats = _both(src, tmp_path, "tcq4", with_imatrix)
    else:
        with mock.patch.object(native, "available", lambda: False), \
                mock.patch.object(jax_native, "available", lambda: False):
            stats = _both(src, tmp_path, "tcq4", with_imatrix)
    assert stats["tcq4"] == 14 and stats["q8_0"] == 2


def test_tcq4_search_matches_jax(src, tmp_path):
    stats = _both(src, tmp_path, "tcq4", True, search=True)
    assert stats["tcq4"] == 14


@pytest.mark.parametrize("with_imatrix", [False, True], ids=["plain", "imatrix"])
@pytest.mark.parametrize("ftype", FTYPES)
def test_ftype_matches_jax(src, tmp_path, ftype, with_imatrix):
    stats = _both(src, tmp_path, ftype, with_imatrix)
    assert stats["type"] == ftype and stats["converted"] > 0


def test_ftype_menu_is_jax_menu():
    assert quantizer._OUT_TYPES == jax_quantizer._OUT_TYPES and len(FTYPES) == 20
    assert quantizer._ENCODERS == jax_quantizer._ENCODERS


def test_cli_quantize_q4_k_m_with_imatrix(src, tmp_path):
    dst = tmp_path / "cli.gguf"
    r = subprocess.run([sys.executable, "-m", "rrs_tpu_torch", "quantize", str(src), str(dst),
                        "--type", "q4_k_m", "--imatrix", str(src.parent / "imatrix.gguf")],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "imatrix-weighted encoders for 16 tensors" in r.stdout and "'mix'" in r.stdout
    jax_quantizer.quantize_model(src, tmp_path / "jax.gguf", verbose=False, out_type="q4_k_m",
                                 imatrix=jax_imatrix.load_imatrix(src.parent / "imatrix.gguf"))
    assert dst.read_bytes() == (tmp_path / "jax.gguf").read_bytes()
