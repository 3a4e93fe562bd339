"""The port's GGUF block codecs (``rrs_tpu_torch/formats/kquants.py``, its own
``iq_grids``) against the JAX package's.

Every dequantizer of JAX's ``_DEQUANT`` decodes the same bytes to the same
f32 bits, through the NumPy route (both native libraries off) and, for the
types with a native kind (Q8_0, Q4_K, Q6_K), through each package's native
host codec. The bytes come from JAX's encoder where the type has one, else
they are random (every bit pattern is a valid block; the f16 scales can be
inf or NaN, which both decode alike, so the comparison is of the bits). TCQ4
decodes as a 2-D weight and as a 3-D expert stack. Every encoder of the
quantize menu gives JAX's bytes, with and without importance weights.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest

from rrs_tpu import native as jax_native
from rrs_tpu.formats import iq_grids as jax_grids
from rrs_tpu.formats import kquants as jax_kquants
from rrs_tpu.formats.tcq4 import quantize_tcq4 as jax_quantize_tcq4
from rrs_tpu.formats.tile_codec import encode_tcq4_gguf as jax_encode_tcq4
from rrs_tpu.gguf.constants import BLOCK_SIZES, GGMLType
from rrs_tpu_torch import native
from rrs_tpu_torch.formats import iq_grids, kquants

import test_torch_common  # noqa: F401  (one torch thread per worker)

# GGMLType -> the JAX encoder that makes its bytes (None: random bytes)
_ENCODER = {
    GGMLType.Q8_0: "quantize_q8_0", GGMLType.Q4_0: "quantize_q4_0",
    GGMLType.Q4_1: "quantize_q4_1", GGMLType.Q5_0: "quantize_q5_0",
    GGMLType.Q5_1: "quantize_q5_1", GGMLType.Q2_K: "quantize_q2_k",
    GGMLType.Q3_K: "quantize_q3_k", GGMLType.Q4_K: "quantize_q4_k",
    GGMLType.Q5_K: "quantize_q5_k", GGMLType.Q6_K: "quantize_q6_k",
    GGMLType.IQ4_NL: "quantize_iq4_nl", GGMLType.IQ4_XS: "quantize_iq4_xs",
    GGMLType.TQ1_0: "quantize_tq1_0", GGMLType.TQ2_0: "quantize_tq2_0",
    GGMLType.MXFP4: "quantize_mxfp4",
}
_NATIVE = (GGMLType.Q8_0, GGMLType.Q4_K, GGMLType.Q6_K)
_CASES = [(t, "numpy") for t in sorted(jax_kquants._DEQUANT, key=int)] + \
    [(t, "native") for t in _NATIVE]

# (encoder, takes importance weights qw)
ENCODERS = [
    ("quantize_q2_k", True), ("quantize_q3_k", True), ("quantize_q4_k", False),
    ("quantize_q5_k", True), ("quantize_q6_k", True), ("quantize_iq4_nl", True),
    ("quantize_iq4_xs", True), ("quantize_q4_0", False), ("quantize_q4_1", False),
    ("quantize_q5_0", False), ("quantize_q5_1", False), ("quantize_q8_0", False),
    ("quantize_tq1_0", False), ("quantize_tq2_0", False), ("quantize_mxfp4", False),
]


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _weights(rng, shape) -> np.ndarray:
    """Normal weights with a few outliers and one all-zero block."""
    x = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    x.reshape(-1)[rng.integers(0, x.size, 8)] *= 20.0
    x.reshape(-1)[:256] = 0.0
    return x


def _routes(route):
    """Both packages' native libraries on (``native``) or off (``numpy``)."""
    if route == "native":
        if not (native.available() and jax_native.available()):
            pytest.skip("a native host codec did not build (no g++)")
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    for m in (native, jax_native):
        stack.enter_context(mock.patch.object(m, "available", lambda: False))
    return stack


def test_iq_grids_are_jax_tables():
    names = [n for n in dir(jax_grids) if n.isupper()]
    assert len(names) >= 7
    for n in names:
        np.testing.assert_array_equal(getattr(iq_grids, n), getattr(jax_grids, n), err_msg=n)


@pytest.mark.parametrize("gt,route", _CASES, ids=[f"{t.name}-{r}" for t, r in _CASES])
def test_dequantize_matches_jax(gt, route):
    rng = np.random.default_rng(int(gt))
    blk, nbytes = BLOCK_SIZES[gt]
    shape = (4, 2 * max(blk, 256))
    enc = _ENCODER.get(gt)
    if enc is None:
        raw = rng.integers(0, 256, size=shape[0] * shape[1] // blk * nbytes, dtype=np.uint8)
    else:
        raw = np.asarray(getattr(jax_kquants, enc)(_weights(rng, shape)), np.uint8).reshape(-1)
    with _routes(route):
        ref = jax_kquants.dequantize(raw, gt, shape)
        got = kquants.dequantize(raw, gt, shape)
    assert got.shape == ref.shape == shape
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("shape", [(16, 512), (3, 24, 256)], ids=["2-D", "expert stack"])
@pytest.mark.parametrize("route", ["numpy", "native"])
def test_tcq4_dequantize_matches_jax(shape, route):
    """The original-domain TCQ4_K32 decode (inverse FWHT and inverse channel
    order) of a 2-D weight and of concatenated per-expert payloads, the
    payloads from JAX's native or NumPy quantizer."""
    rng = np.random.default_rng(1)
    mats = _weights(rng, shape).reshape(-1, *shape[-2:])
    with _routes(route):
        raw = np.frombuffer(b"".join(bytes(jax_encode_tcq4(jax_quantize_tcq4(m))) for m in mats),
                            np.uint8)
        ref = jax_kquants.dequantize(raw, GGMLType.TCQ4_K32, shape)
        got = kquants.dequantize(raw, GGMLType.TCQ4_K32, shape)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


_ENC_CASES = [(name, w) for name, takes_qw in ENCODERS for w in (False, True)
              if takes_qw or not w]


@pytest.mark.parametrize("name,weighted", _ENC_CASES,
                         ids=[f"{n[9:]}-{'qw' if w else 'plain'}" for n, w in _ENC_CASES])
def test_encoder_matches_jax(name, weighted):
    rng = np.random.default_rng(7)
    x = _weights(rng, (6, 512))
    kw = {"qw": (rng.random(x.shape) * 4 + 0.05).astype(np.float32)} if weighted else {}
    ref = np.asarray(getattr(jax_kquants, name)(x, **kw), np.uint8)
    got = np.asarray(getattr(kquants, name)(x, **kw), np.uint8)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_unknown_type_raises():
    with pytest.raises(NotImplementedError):
        kquants.dequantize(np.zeros(8, np.uint8), GGMLType.Q8_1, (32,))
