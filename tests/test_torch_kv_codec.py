"""The KV-cache codec of rrs_tpu_torch against rrs_tpu.runtime.kv_codec, bit
for bit: row quantization (random rows, values within an ulp of a code's
half-way point, all-zero rows that hit the 1e-10 scale floor), the q4 halves
and head-pair packs, and dequantization of every layout, for odd and even
head counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.runtime import kv_codec as jkc
from rrs_tpu_torch.runtime import kv_codec as tkc


def _rows(kind: str, qmax: float, shape=(2, 3, 16, 64), seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal(shape).astype(np.float32)
    if kind == "zeros":
        x = rng.standard_normal(shape).astype(np.float32)
        x[:, :, ::3] = 0.0                             # every third slot is all zero
        return x
    # half-way points: each row's amax sets the scale; the other elements sit
    # at (k + 0.5) * scale, nudged one ulp down, not at all, or up
    lead, d = shape[:-1], shape[-1]
    amax = (rng.random(lead) * 4 + 0.1).astype(np.float32)
    k = rng.integers(-int(qmax), int(qmax), lead + (d - 1,)).astype(np.float32)
    x = ((k + 0.5) * (amax[..., None] / np.float32(qmax))).astype(np.float32)
    step = rng.choice([-1, 0, 1], x.shape).astype(np.float32)
    x = np.nextafter(x, x + step)
    return np.concatenate([amax[..., None], x], axis=-1)


@pytest.mark.parametrize("qmax", [7.0, 127.0])
@pytest.mark.parametrize("kind", ["random", "half_way", "zeros"])
def test_quantize_rows_bit_exact(kind, qmax):
    x = _rows(kind, qmax)
    jq, js = jkc.quantize_rows(jnp.asarray(x), qmax)
    tq, ts = tkc.quantize_rows(torch.from_numpy(x), qmax)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    if kind == "zeros":
        assert (ts.numpy()[:, :, ::3] == np.float32(1e-10)).all()
    if kind == "half_way":
        # the scale is a true division: the CUDA division by a CPU scalar,
        # amax * (1 / qmax), rounds some of these scales differently
        amax = np.abs(x).max(-1)
        assert (amax * np.float32(1.0 / qmax) != np.asarray(js)).any()


@pytest.mark.parametrize("heads", [1, 3, 4])
def test_pack4_roundtrip_matches(heads):
    x = _rows("random", 7.0, shape=(2, heads, 8, 64), seed=heads)
    q, _ = jkc.quantize_rows(jnp.asarray(x), 7.0)
    tq = torch.from_numpy(np.array(q))
    packed = tkc.pack4(tq)
    assert packed.dtype == torch.uint8 and packed.shape == (2, heads, 8, 32)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jkc.pack4(q)))
    np.testing.assert_array_equal(tkc.unpack4(packed).numpy(),
                                  np.asarray(jkc.unpack4(jkc.pack4(q))))
    np.testing.assert_array_equal(tkc.unpack4(packed).numpy(), np.asarray(q))


@pytest.mark.parametrize("heads", [2, 4, 8])
def test_pack_hp_roundtrip_matches(heads):
    x = _rows("random", 7.0, shape=(2, heads, 8, 64), seed=10 + heads)
    q, s = jkc.quantize_rows(jnp.asarray(x), 7.0)
    tq = torch.from_numpy(np.array(q))
    packed = tkc.pack_hp(tq)
    assert packed.dtype == torch.uint8 and packed.shape == (2, heads // 2, 8, 64)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jkc.pack_hp(q)))
    np.testing.assert_array_equal(tkc.unpack_hp(packed).numpy(),
                                  np.asarray(jkc.unpack_hp(jkc.pack_hp(q))))
    sc = np.asarray(s)[:, :, None, :]
    assert tkc.is_head_pair(packed, torch.from_numpy(sc))
    assert jkc.is_head_pair(jkc.pack_hp(q), jnp.asarray(sc))


@pytest.mark.parametrize("layout,heads", [("q8", 3), ("q8", 4), ("q4hp", 4), ("q4", 3),
                                          ("q4", 4)])
def test_dequantize_matches(layout, heads):
    qmax = 127.0 if layout == "q8" else 7.0
    x = _rows("random", qmax, shape=(2, heads, 8, 64), seed=20 + heads)
    q, s = jkc.quantize_rows(jnp.asarray(x), qmax)
    arr = {"q8": q, "q4hp": jkc.pack_hp(q), "q4": jkc.pack4(q)}[layout]
    sc = jnp.asarray(np.asarray(s)[:, :, None, :])               # [B, H, 1, S]
    tarr, tsc = torch.from_numpy(np.array(arr)), torch.from_numpy(np.array(sc))
    assert tkc.is_head_pair(tarr, tsc) == jkc.is_head_pair(arr, sc) == (layout == "q4hp")
    assert tkc.kv_qmax(tarr) == jkc.kv_qmax(arr) == qmax
    np.testing.assert_array_equal(tkc.dequantize(tarr, tsc).numpy(),
                                  np.asarray(jkc.dequantize(arr, sc)))
