"""The MXFP4 ops of rrs_tpu_torch against rrs_tpu's: the device repack is
byte-equal, the decode bit-equal, and the plain versions of kernels B11-B13
agree with the JAX kernels run in interpret mode (as tests/test_mxfp4.py runs
them) within 1e-5 of the output's largest magnitude: both take bf16(a) times
weights that are exact in bf16 with f32 sums, so only the order of the sums
differs. ``MXFP4Linear`` (with N padding, bias and fusion) matches the JAX
``linear_apply``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.formats.kquants import dequantize_mxfp4, quantize_mxfp4
from rrs_tpu.ops import mxfp4_matmul as jmx
from rrs_tpu_torch.ops import mxfp4_matmul as tmx

from test_torch_common import rel_err

TOL = 1e-5


def _random_mxfp4(rng, n, k):
    w = rng.standard_normal((n, k)).astype(np.float32)
    raw = quantize_mxfp4(w)
    return raw, dequantize_mxfp4(raw, n * k).reshape(n, k)


def _stacks(rng, n_exp, n, k):
    packed = [jmx.pack_mxfp4_device(_random_mxfp4(rng, n, k)[0], (n, k)) for _ in range(n_exp)]
    return np.stack([p[0] for p in packed]), np.stack([p[1] for p in packed])


@pytest.mark.parametrize("n,k", [(272, 320), (192, 128), (64, 192)])
def test_pack_device_byte_equal(n, k):
    raw, _ = _random_mxfp4(np.random.default_rng(n + k), n, k)
    jq, js = jmx.pack_mxfp4_device(raw, (n, k))
    tq, ts = tmx.pack_mxfp4_device(raw, (n, k))
    assert tq.dtype == np.uint8 and ts.dtype == np.uint8
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(ts, js)


def test_pack_refuses_k_not_multiple_of_64():
    raw, _ = _random_mxfp4(np.random.default_rng(0), 64, 96)
    with pytest.raises(ValueError, match="K % 64"):
        tmx.pack_mxfp4_device(raw, (64, 96))


def test_dequant_bit_equal():
    """Every bit, signed zeros included, on real codes and on every byte
    value with the extreme exponents; a stack decodes per expert."""
    rng = np.random.default_rng(1)
    raw, wd = _random_mxfp4(rng, 272, 320)
    qs, sx = jmx.pack_mxfp4_device(raw, (272, 320))
    ref = np.asarray(jmx.dequant_mxfp4_jnp(jnp.asarray(qs), jnp.asarray(sx)))
    got = tmx.dequant_mxfp4(torch.from_numpy(qs), torch.from_numpy(sx)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    np.testing.assert_array_equal(got[:, :272].T, wd)
    qs = np.tile(np.arange(256, dtype=np.uint8)[:, None], (1, 128))            # K = 512
    sx = rng.choice(np.array([1, 127, 251], np.uint8), size=(16, 128))
    ref = np.asarray(jmx.dequant_mxfp4_jnp(jnp.asarray(qs), jnp.asarray(sx)))
    got = tmx.dequant_mxfp4(torch.from_numpy(qs), torch.from_numpy(sx)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    sq, ss = _stacks(rng, 3, 64, 128)
    stack = tmx.dequant_mxfp4(torch.from_numpy(sq), torch.from_numpy(ss))
    for e in range(3):
        np.testing.assert_array_equal(
            stack[e].numpy(), np.asarray(jmx.dequant_mxfp4_jnp(jnp.asarray(sq[e]),
                                                               jnp.asarray(ss[e]))))


@pytest.mark.parametrize("m", [1, 4, 33])
def test_b11_plain_matches_jax_kernel(m):
    rng = np.random.default_rng(2)
    raw, wd = _random_mxfp4(rng, 272, 320)
    qs, sx = jmx.pack_mxfp4_device(raw, (272, 320))
    a = rng.standard_normal((m, 320)).astype(np.float32)
    ref = np.asarray(jmx.mxfp4_matmul(jnp.asarray(a), jnp.asarray(qs), jnp.asarray(sx),
                                      interpret=True))
    got = tmx.mxfp4_matmul(torch.from_numpy(a), torch.from_numpy(qs), torch.from_numpy(sx))
    assert got.dtype == torch.float32 and got.shape == (m, 384)
    assert rel_err(got.numpy(), ref) < TOL
    # the f32 oracle takes a unrounded, as the JAX one does
    oracle = np.asarray(jmx.mxfp4_matmul_ref(jnp.asarray(a), jnp.asarray(qs), jnp.asarray(sx)))
    got = tmx.mxfp4_matmul_ref(torch.from_numpy(a), torch.from_numpy(qs), torch.from_numpy(sx))
    assert rel_err(got.numpy(), oracle) < TOL


def test_b12_plain_matches_jax_kernel():
    rng = np.random.default_rng(3)
    qs, sx = _stacks(rng, 4, 272, 320)
    ids = np.array([2, 0, 3, 3, 1, 2], np.int32)
    a = rng.standard_normal((len(ids), 320)).astype(np.float32)
    ref = np.asarray(jmx.mxfp4_matmul_experts_rows(jnp.asarray(a), jnp.asarray(qs),
                                                   jnp.asarray(sx), jnp.asarray(ids),
                                                   interpret=True))
    got = tmx.mxfp4_matmul_experts_rows(torch.from_numpy(a), torch.from_numpy(qs),
                                        torch.from_numpy(sx), torch.from_numpy(ids))
    assert got.shape == (len(ids), 384)
    assert rel_err(got.numpy(), ref) < TOL


@pytest.mark.parametrize("per_expert", [False, True], ids=["shared", "per-expert"])
def test_b13_plain_matches_jax_kernel(per_expert):
    rng = np.random.default_rng(4)
    n_exp, t = 3, 5                                            # T not a multiple of 8
    qs, sx = _stacks(rng, n_exp, 272, 320)
    shape = (n_exp, t, 320) if per_expert else (t, 320)
    a = rng.standard_normal(shape).astype(np.float32)
    ref = np.asarray(jmx.mxfp4_matmul_all_experts(jnp.asarray(a), jnp.asarray(qs),
                                                  jnp.asarray(sx), interpret=True))
    got = tmx.mxfp4_matmul_all_experts(torch.from_numpy(a), torch.from_numpy(qs),
                                       torch.from_numpy(sx))
    assert got.shape == (n_exp, t, 384)
    assert rel_err(got.numpy(), ref) < TOL


def test_wrappers_refuse_bad_shapes():
    qs = torch.zeros((160, 128), dtype=torch.uint8)
    sx = torch.zeros((10, 128), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tmx.mxfp4_matmul(torch.zeros(2, 256), qs, sx)              # K 256 vs qs 320
    with pytest.raises(ValueError):
        tmx.mxfp4_matmul(torch.zeros(2, 320), qs[:, :96], sx[:, :96])   # N not a 64-multiple
    with pytest.raises(ValueError):
        tmx.mxfp4_matmul_experts_rows(torch.zeros(2, 320), qs[None], sx[None],
                                      torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        tmx.mxfp4_matmul_all_experts(torch.zeros(2, 2, 320), qs[None], sx[None])


def test_mxfp4_linear_matches_jax():
    from rrs_tpu.models.linear import MXFP4Linear as JLin
    from rrs_tpu.models.linear import fuse_linears as jfuse
    from rrs_tpu.models.linear import linear_apply as japply
    from rrs_tpu_torch.models.linear import MXFP4Linear, fuse_linears, linear_apply

    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 320)) * 0.5).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    raws = [_random_mxfp4(rng, n, 320)[0] for n in (272, 128, 256)]
    biases = [rng.standard_normal((n,)).astype(np.float32) for n in (272, 128, 256)]
    jl = [JLin.from_gguf(r, (n, 320), bias=b) for r, n, b in zip(raws, (272, 128, 256), biases)]
    tl = [MXFP4Linear.from_gguf(r, (n, 320), bias=b) for r, n, b in zip(raws, (272, 128, 256),
                                                                          biases)]
    assert tl[0].shape == (320, 272) and tl[0].qs.shape == (160, 384)
    ref = np.asarray(japply(jl[0], xb), np.float32)
    got = linear_apply(tl[0], xt)
    assert got.shape == (3, 272) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=8e-3, atol=1e-6)
    # a padded segment cannot fuse; unpadded ones fuse along N with their biases
    assert fuse_linears(tl) is None and jfuse(jl) is None
    fused, jfused = fuse_linears(tl[1:]), jfuse(jl[1:])
    assert fused.qs.shape == (160, 384)
    np.testing.assert_allclose(linear_apply(fused, xt).float().numpy(),
                               np.asarray(japply(jfused, xb), np.float32), rtol=8e-3, atol=1e-6)
