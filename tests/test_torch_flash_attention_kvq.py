"""Attention over quantized KV caches: the plain versions of rrs_tpu_torch's
flash_attention_q8 / _q4hp / _q4 (dequantize, then attend; what the CUDA
kernels are held against on the card) against rrs_tpu's Pallas kernels in
interpret mode, on the same codes and scales, with a padded row, a dead lane,
softcap, a sliding window over a ring cache, sinks and ALiBi. Tolerances are
the JAX tests' own (tests/test_flash_attention.py: 2e-5 for q8, 2e-4 for
q4hp; 2e-4 for q4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.ops import flash_attention as jfa
from rrs_tpu.runtime import kv_codec as jkc
from rrs_tpu_torch import kernels
from rrs_tpu_torch.ops import flash_attention as tfa
from rrs_tpu_torch.runtime import kv_codec as tkc

CODECS = {
    "q8": (jfa.flash_attention_q8, tfa.flash_attention_q8, 2e-5),
    "q4hp": (jfa.flash_attention_q4hp, tfa.flash_attention_q4hp, 2e-4),
    "q4": (jfa.flash_attention_q4, tfa.flash_attention_q4, 2e-4),
}
OPTIONS = {
    "padded_row_dead_lane": dict(b=2),
    "softcap": dict(softcap=5.0),
    "window_ring": dict(window=24, start=150),
    "sinks": dict(sinks=True),
    "alibi": dict(alibi=8.0, h=8, hkv=4),
}


def _inputs(codec, b=1, t=3, h=4, hkv=2, s=128, d=64, start=60, seed=0, **_):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    caches = []
    for _ in range(2):
        x = jnp.asarray(rng.standard_normal((b, hkv, s, d)).astype(np.float32))
        codes, sc = jkc.quantize_rows(x, 127.0 if codec == "q8" else 7.0)
        codes = {"q8": codes, "q4hp": jkc.pack_hp(codes), "q4": jkc.pack4(codes)}[codec]
        caches += [np.array(codes), np.array(sc)[:, :, None, :]]
    pos = np.tile(np.arange(start, start + t, dtype=np.int32), (b, 1))
    pos[0, -1] = -1                                     # a padded row
    if b > 1:
        pos[1] = -1                                     # a lane with no token
    return q, caches, pos


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_kvq_plain_matches_jax_kernel(codec, option):
    jfn, tfn, tol = CODECS[codec]
    c = OPTIONS[option]
    q, caches, pos = _inputs(codec, **c)
    h = q.shape[2]
    scale = 1.0 / np.sqrt(q.shape[-1])
    kw = dict(softcap=c.get("softcap", 0.0), window=c.get("window", 0),
              alibi=c.get("alibi", 0.0))
    sinks = np.linspace(-1.0, 1.0, h).astype(np.float32) if c.get("sinks") else None
    ref = np.asarray(jfn(jnp.asarray(q), *(jnp.asarray(a) for a in caches), jnp.asarray(pos),
                         scale, interpret=True,
                         sinks=None if sinks is None else jnp.asarray(sinks), **kw))
    before = dict(kernels.LAUNCHES)
    got = tfn(torch.from_numpy(q), *(torch.from_numpy(a) for a in caches),
              torch.from_numpy(pos), scale,
              sinks=None if sinks is None else torch.from_numpy(sinks), **kw).numpy()
    assert kernels.LAUNCHES == before                  # CPU tensors take the plain version
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    assert np.all(got[pos < 0] == 0.0)                 # padded rows output exactly 0
    # the plain version is dequantize, then attention_ref
    tc = [torch.from_numpy(a) for a in caches]
    plain = tfa.attention_ref(torch.from_numpy(q), tkc.dequantize(*tc[:2]),
                              tkc.dequantize(*tc[2:]), torch.from_numpy(pos), scale,
                              sinks=None if sinks is None else torch.from_numpy(sinks),
                              **kw).numpy()
    np.testing.assert_array_equal(got, plain)


def test_kvq_wrappers_refuse_bad_shapes_before_launch():
    """On a device tensor a wrapper launches or raises; shapes it cannot take
    are refused by the checks that run first (exercised here with meta
    tensors, which never reach a kernel)."""
    q = torch.empty((1, 1, 4, 64), dtype=torch.bfloat16, device="meta")
    codes = torch.empty((1, 2, 16, 64), dtype=torch.uint8, device="meta")
    sc = torch.empty((1, 2, 1, 16), dtype=torch.float32, device="meta")
    pos = torch.empty((1, 1), dtype=torch.int32, device="meta")
    # head-pair codes must hold Hkv / 2 planes
    with pytest.raises(ValueError, match="shapes"):
        tfa.flash_attention_q4hp(q, codes, sc, codes, sc, pos, 0.125)
    # halves codes hold D / 2 bytes per slot
    with pytest.raises(ValueError, match="shapes"):
        tfa.flash_attention_q4(q, codes, sc, codes, sc, pos, 0.125)
    with pytest.raises(TypeError, match="int8"):
        tfa.flash_attention_q8(q, codes, sc, codes, sc, pos, 0.125)
    q48 = torch.empty((1, 1, 4, 48), dtype=torch.bfloat16, device="meta")
    c48 = torch.empty((1, 2, 16, 48), dtype=torch.int8, device="meta")
    with pytest.raises(NotImplementedError, match="head dim 48"):
        tfa.flash_attention_q8(q48, c48, sc, c48, sc, pos, 0.125)
