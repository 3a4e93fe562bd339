"""The TCQ4 mixture-of-experts kernels' plain versions against rrs_tpu:
``tcq4_matmul_experts_rows`` (B9) and ``tcq4_matmul_all_experts`` (B10) run
in interpret mode, as the JAX package's own tests run them, on the same NumPy
inputs; ``quantize_experts`` and ``_dequant_expert`` bit for bit; and the
wrappers' shape and type checks.

The kernels and the plain versions round the activations and each
int4 * f32(eff) weight to bf16, so every product is exact in f32 and only the
order of the f32 sums differs (the TPU kernels sum each 256-superblock's dot
and then the superblocks): held within 1e-5 of the largest output."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.models import moe as jax_moe
from rrs_tpu.ops import tcq4_matmul as jax_tm
from rrs_tpu_torch.models import moe
from rrs_tpu_torch.ops import tcq4_matmul as tm

from test_torch_common import rel_err

TOL = 1e-5


def _stacks(rng, n_exp, k, n):
    qs = rng.integers(0, 256, (n_exp, k // 2, n), dtype=np.uint8)
    eff = (rng.random((n_exp, k // 32, n), dtype=np.float32) * 0.01 + 1e-3)
    eff = np.asarray(jnp.asarray(eff, jnp.bfloat16))          # bf16 on both sides
    return qs, eff


def _torch(qs, eff):
    return (torch.from_numpy(qs),
            torch.from_numpy(eff.view(np.uint16).copy()).view(torch.bfloat16))


def _act(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bf16":
        a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return a, torch.from_numpy(a).to(torch.bfloat16 if dtype == "bf16" else torch.float32)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("k,n", [(512, 256), (256, 200)], ids=["K512 N256", "K256 N200"])
def test_experts_rows_plain_matches_jax(k, n, dtype):
    """Row i against expert ids[i], with repeated ids (two rows on expert 2,
    three on expert 0) and an expert no row selects."""
    rng = np.random.default_rng(k + n)
    qs, eff = _stacks(rng, 4, k, n)
    ids = np.array([2, 0, 3, 0, 2, 0], np.int32)
    a_np, a_t = _act(rng, (ids.size, k), dtype)
    ref = np.asarray(jax_tm.tcq4_matmul_experts_rows(
        jnp.asarray(a_np), jnp.asarray(qs), jnp.asarray(eff, jnp.bfloat16), jnp.asarray(ids),
        interpret=True))
    got = tm.tcq4_matmul_experts_rows(a_t, *_torch(qs, eff), torch.from_numpy(ids).long())
    assert got.dtype == torch.float32 and got.shape == (ids.size, n)
    assert rel_err(got.numpy(), ref) < TOL


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("layout", ["shared", "per-expert"])
def test_all_experts_plain_matches_jax(layout, dtype):
    """Every expert over shared activations [T, K] or its own [E, T, K]; T = 5
    is not a multiple of the kernels' 8-row padding."""
    rng = np.random.default_rng(3)
    n_exp, t, k, n = 3, 5, 512, 256
    qs, eff = _stacks(rng, n_exp, k, n)
    a_np, a_t = _act(rng, (t, k) if layout == "shared" else (n_exp, t, k), dtype)
    ref = np.asarray(jax_tm.tcq4_matmul_all_experts(
        jnp.asarray(a_np), jnp.asarray(qs), jnp.asarray(eff, jnp.bfloat16), interpret=True))
    got = tm.tcq4_matmul_all_experts(a_t, *_torch(qs, eff))
    assert got.dtype == torch.float32 and got.shape == (n_exp, t, n)
    assert rel_err(got.numpy(), ref) < TOL


def test_quantize_experts_matches_jax():
    rng = np.random.default_rng(6)
    n_exp, e, f = 3, 256, 512
    dense = {name: np.asarray(jnp.asarray(rng.standard_normal(shape) * 0.02, jnp.bfloat16))
             for name, shape in (("gate", (n_exp, e, f)), ("up", (n_exp, e, f)),
                                 ("down", (n_exp, f, e)))}
    router = rng.standard_normal((e, n_exp)).astype(np.float32)
    jq = jax_moe.quantize_experts(jax_moe.MoEWeights(
        router=jnp.asarray(router), **{k: jnp.asarray(v) for k, v in dense.items()}))
    tq = moe.quantize_experts(moe.MoEWeights(
        router=torch.from_numpy(router),
        **{k: torch.from_numpy(v.view(np.uint16).copy()).view(torch.bfloat16)
           for k, v in dense.items()}))
    assert tq.quant_kind == "tcq4" and tq.quantized and tq.gate is tq.up is tq.down is None
    for name in ("gate_qs", "gate_eff", "up_qs", "up_eff", "down_qs", "down_eff"):
        ref = np.asarray(getattr(jq, name))
        got = getattr(tq, name)
        if got.dtype == torch.bfloat16:
            got, ref = got.view(torch.uint16), ref.view(np.uint16)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)


def test_dequant_expert_matches_jax():
    """[T, k, K//2, F] gathered tiles, as the JAX scan fallback calls it."""
    rng = np.random.default_rng(7)
    qs, eff = _stacks(rng, 6, 512, 64)
    qs, eff = qs.reshape(2, 3, 256, 64), eff.reshape(2, 3, 16, 64)
    ref = np.asarray(jax_moe._dequant_expert(jnp.asarray(qs), jnp.asarray(eff, jnp.bfloat16)))
    got = moe._dequant_expert(*_torch(qs, eff))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 512, 64)
    np.testing.assert_array_equal(got.view(torch.uint16).numpy(), ref.view(np.uint16))


def test_shapes_and_types_raise():
    rng = np.random.default_rng(8)
    qs, eff = _torch(*_stacks(rng, 2, 256, 64))
    a = torch.zeros((3, 256))
    with pytest.raises(ValueError, match="K a multiple of 256"):
        tm.tcq4_matmul_experts_rows(torch.zeros((3, 128)), qs, eff,
                                    torch.zeros(3, dtype=torch.long))
    with pytest.raises(ValueError, match="ids"):
        tm.tcq4_matmul_experts_rows(a, qs, eff, torch.zeros(2, dtype=torch.long))
    with pytest.raises(ValueError, match="K a multiple of 256"):
        tm.tcq4_matmul_all_experts(a, qs, eff[:, :4])
    with pytest.raises(ValueError, match="experts"):
        tm.tcq4_matmul_all_experts(torch.zeros((3, 4, 256)), qs, eff)
    with pytest.raises(ValueError, match="K a multiple of 256"):
        tm.tcq4_matmul_all_experts(a, qs[:, :, :60].contiguous(), eff[:, :, :60].contiguous())
    # the type checks a wrapper makes on CUDA tensors before it launches
    with pytest.raises(TypeError, match="bf16 or f32 a"):
        tm._check_types("tcq4_matmul_all_experts", a.to(torch.float16), qs, eff)
    with pytest.raises(TypeError, match="uint8 qs, bf16 eff"):
        tm._check_types("tcq4_matmul_experts_rows", a, qs, eff.float())
