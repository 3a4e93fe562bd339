"""B5, the int8-superblock prefill kernel, of rrs_tpu_torch against rrs_tpu:
the load-time pack, the activation permutation, the plain version (which the
CUDA kernel is held against on the card) against the JAX kernel in interpret
mode, the plain version against the port's dequant path, and the route.

The JAX route never takes i8p on the CPU (it skips the kernel in interpret
mode), so the route is held to JAX at the kernel level, and the kernel each
layer gets is pinned by whether it carries a pack: the port must pack and
drop packs exactly where the JAX package does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.formats import tcq4 as jtcq4
from rrs_tpu.models import linear as jlinear
from rrs_tpu.ops import tcq4_matmul as jmm
from rrs_tpu_torch.formats import tcq4 as ttcq4
from rrs_tpu_torch.models import linear as tlinear
from rrs_tpu_torch.ops import tcq4_matmul as tmm

from test_torch_common import rel_err, torch_cfg, jax_cfg


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a).view(np.uint16)).view(
        torch.bfloat16)


def _layer(n, k, seed):
    """qs and bf16 eff of a quantized random weight, in both packages' types."""
    rng = np.random.default_rng(seed)
    t = jtcq4.quantize_tcq4((rng.standard_normal((n, k)) * 0.05).astype(np.float32),
                            use_native=False)
    qs = np.ascontiguousarray(t.qs)
    eff = jnp.asarray(jtcq4.effective_scales(t), jnp.bfloat16)
    return qs, eff


def _acts(m, k, seed):
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32) * 0.3
    jq, js = jtcq4.quantize_activations_rrs(jnp.asarray(x))
    return jq, js, torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(js))


@pytest.mark.parametrize("k,n", [(512, 256), (768, 200)])
def test_pack_i8p_matches_jax(k, n):
    qs, eff = _layer(n, k, seed=k + n)
    jq, jf, je = jmm.pack_i8p(jnp.asarray(qs), eff)
    tq, tf, te = tmm.pack_i8p(torch.from_numpy(qs), _bf16(eff))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert te.dtype == torch.float32
    assert rel_err(te.numpy(), np.asarray(je)) <= 1e-7


def test_prep_a_sbi_exact():
    jq, _, tq, _ = _acts(5, 768, seed=1)
    np.testing.assert_array_equal(tmm.prep_a_sbi(tq).numpy(), np.asarray(jmm.prep_a_sbi(jq)))


@pytest.mark.parametrize("m,k,n", [(48, 512, 256), (300, 768, 128), (1024, 512, 256)])
def test_plain_matches_jax_kernel(m, k, n):
    """The JAX kernel in interpret mode at the route's bm=512; f32 output
    rel 1e-5 (the same f32 operations in the same order), bf16 output
    (padded M >= 1024) 8e-3: one bf16 ulp where the sums round to either
    side."""
    qs, eff = _layer(n, k, seed=m)
    jq, js, tq, ts = _acts(m, k, seed=m + 1)
    ref = np.asarray(jmm.tcq4_matmul_i8p(jmm.prep_a_sbi(jq), js,
                                         *jmm.pack_i8p(jnp.asarray(qs), eff),
                                         bm=512, interpret=True))
    got = tmm.tcq4_matmul_i8p(tmm.prep_a_sbi(tq), ts, *tmm.pack_i8p(torch.from_numpy(qs),
                                                                     _bf16(eff)))
    out_bf16 = m >= 1024
    assert got.dtype == (torch.bfloat16 if out_bf16 else torch.float32)
    assert str(ref.dtype) == ("bfloat16" if out_bf16 else "float32")
    assert rel_err(got.float().numpy(), ref.astype(np.float32)) <= (8e-3 if out_bf16 else 1e-5)


def test_out_dtype_at_bm_512():
    """bf16 once round_up(m, min(512, round_up(m, 8))) reaches 1024: at M=700
    the route's bm=512 pads to 1024 (the kernel's default bm=256 would pad to
    768); linear_apply rounds the result to bf16 either way."""
    assert not tmm.i8p_out_bf16(512)
    assert tmm.i8p_out_bf16(700) and tmm.i8p_out_bf16(1024) and tmm.i8p_out_bf16(4096)
    assert not tmm.i8p_out_bf16(256)


def test_plain_close_to_dequant_path():
    """The requant bound of tests/test_tcq4_matmul.py:278-310: w8 adds at most
    4/127 * emax per element."""
    m, k, n = 48, 512, 256
    qs, eff = _layer(n, k, seed=3)
    _, _, tq, ts = _acts(m, k, seed=4)
    qs_t, eff_t = torch.from_numpy(qs), _bf16(eff)
    ref = tmm.tcq4_matmul(ttcq4.dequantize_activations_rrs(tq, ts), qs_t, eff_t).numpy()
    got = tmm.tcq4_matmul_i8p(tmm.prep_a_sbi(tq), ts, *tmm.pack_i8p(qs_t, eff_t)).numpy()
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.9999
    assert np.abs(got - ref).max() < 0.06 * max(np.abs(ref).mean(), 1e-6) + 0.02


def test_route_by_m_and_pack(monkeypatch):
    """A pack and M >= 256 go to i8p (the result is the kernel's, rounded to
    the input dtype); below 256, or without a pack, the dequant kernel."""
    k, n = 512, 256
    qs, eff = _layer(n, k, seed=5)
    qs_t, eff_t = torch.from_numpy(qs), _bf16(eff)
    packed = tlinear.TCQ4Linear(qs=qs_t, eff=eff_t, i8p=tmm.pack_i8p(qs_t, eff_t))
    bare = tlinear.TCQ4Linear(qs=qs_t, eff=eff_t)
    calls = []
    for name in ("tcq4_matmul_i8p", "tcq4_matmul", "tcq4_matmul_gx2"):
        fn = getattr(tmm, name)
        monkeypatch.setattr(tmm, name, lambda *a, _f=fn, _n=name: calls.append(_n) or _f(*a))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 256, k)).astype(np.float32))
    for layer, m, want in ((packed, 256, "tcq4_matmul_i8p"), (packed, 255, "tcq4_matmul"),
                           (packed, 8, "tcq4_matmul_gx2"), (bare, 256, "tcq4_matmul")):
        calls.clear()
        y = tlinear.linear_apply(layer, x[:, :m])
        assert calls == [want], (m, calls)
    rot = tlinear.rotate_activations(x[0], None)
    a_q, a_s = ttcq4.quantize_activations_rrs(rot)
    direct = tmm.tcq4_matmul_i8p_plain(tmm.prep_a_sbi(a_q), a_s, *packed.i8p)
    np.testing.assert_array_equal(tlinear.linear_apply(packed, x)[0].numpy(), direct.numpy())
    assert y.shape == (1, 256, n)


def test_packs_follow_jax(monkeypatch):
    """Where the JAX package packs, the port packs; fuse_linears drops the
    pack in both (so a GGUF-loaded model's fused qkv and gate-up prefill
    through tcq4_matmul); fabricated weights pack every projection at its
    fused width in both; RRS_PREFILL_I8=0 turns packing off in both."""
    from rrs_tpu.models import llama as jllama
    from rrs_tpu_torch.models import llama as tllama
    from rrs_tpu_torch.models.llama import weights_from_numpy

    from test_torch_common import weights_tree

    monkeypatch.setenv("RRS_PREFILL_I8", "1")
    rng = np.random.default_rng(7)
    tens = [jtcq4.quantize_tcq4((rng.standard_normal((128, 256)) * 0.05).astype(np.float32),
                                use_native=False) for _ in range(2)]
    jl = [jlinear.TCQ4Linear.from_tensor(t) for t in tens]
    tl = [tlinear.TCQ4Linear.from_tensor(t) for t in tens]
    assert all(x.i8p is not None for x in jl + tl)
    for a, b in zip(jl, tl):
        for ja, ta in zip(a.i8p, b.i8p):
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert jlinear.fuse_linears(jl).i8p is None
    assert tlinear.fuse_linears(tl).i8p is None

    cfg = jax_cfg()
    jw = jllama.fabricated_tcq4_weights(cfg, seed=0)
    tw = tllama.fabricated_tcq4_weights(torch_cfg(cfg), seed=0, device="cpu")
    for jlw, tlw in zip(jw.layers, tw.layers):
        for name in ("wqkv", "wo", "w_gateup", "w_down"):
            jlin, tlin = getattr(jlw, name), getattr(tlw, name)
            assert jlin.i8p is not None and tlin.i8p is not None, name
            assert tuple(tlin.i8p[0].shape) == tuple(jlin.i8p[0].shape)
    # the pack crosses over as it is
    tw2 = weights_from_numpy(torch_cfg(cfg), weights_tree(jw), device="cpu")
    for ja, ta in zip(jw.layers[0].wqkv.i8p, tw2.layers[0].wqkv.i8p):
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))

    monkeypatch.setenv("RRS_PREFILL_I8", "0")
    assert tlinear.TCQ4Linear.from_tensor(tens[0]).i8p is None
    assert jlinear.TCQ4Linear.from_tensor(tens[0]).i8p is None
    assert tllama.fabricated_tcq4_weights(torch_cfg(cfg), seed=0, device="cpu").layers[0].wo.i8p \
        is None
