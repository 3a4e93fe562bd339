"""KV cache lanes of rrs_tpu_torch against rrs_tpu's, and the in-place store:
a lane with no token in a step writes nothing to its cache (the JAX package
parks its K/V rows in the last T slots of a T-row step, which overwrites a
lane holding more than S - T rows: ROADMAP queue C3) and leaves the live
lane's logits as a one-lane context computes them. Quantized caches (q8, q4 head-pair, q4
halves): their layouts, the store of new rows, seq_cp and seq_shift against
the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.runtime.kv_cache import KVCache as JaxKVCache
from rrs_tpu_torch.models import llama
from rrs_tpu_torch.runtime.context import InferenceContext
from rrs_tpu_torch.runtime.kv_cache import KVCache

from test_torch_common import jax_cfg, torch_cfg


def _ops(kv):
    """One script of lane operations; returns the lane state after each."""
    states = []
    for op, arg in [("new", 10), ("new", 11), ("len", (10, 7)), ("new", 12), ("new", 13),
                    ("len", (11, 9)), ("rm_tail", (11, 3)), ("rm_tail", (10, 8)), ("rm", 11),
                    ("new", 14), ("rm", 10), ("new", 15)]:
        if op == "new":
            try:
                kv.seq_new(arg)
            except RuntimeError as e:
                states.append(("error", str(e)))
                continue
        elif op == "len":
            kv.lengths[kv.lane_of(arg[0])] = arg[1]
        elif op == "rm_tail":
            kv.seq_rm(*arg)
        elif op == "rm":
            kv.seq_rm(arg)
        states.append((list(kv.seq_ids), list(kv.lengths), kv.lane_of(arg if op == "new" else arg[0])
                       if op != "rm" else None))
    return states


def test_lane_bookkeeping_matches_jax():
    jcfg = jax_cfg(n_layers=1)
    ref = _ops(JaxKVCache.create(jcfg, n_lanes=3, max_seq=32))
    got = _ops(KVCache.create(torch_cfg(jcfg), n_lanes=3, max_seq=32))
    assert got == ref


def test_idle_lane_parks_writes_at_top_slot():
    cfg = torch_cfg(jax_cfg())
    w = llama.random_weights(cfg, seed=3, quantize=True, device="cpu")
    one = InferenceContext(cfg, w, n_lanes=1, max_seq=64, device="cpu")
    two = InferenceContext(cfg, w, n_lanes=2, max_seq=64, device="cpu")
    prompt = [5, 9, 2, 77, 31]
    outs = []
    for ctx in (one, two):
        seq = ctx.new_sequence()
        pre = ctx.prefill(seq, prompt)
        dec = ctx.decode({seq: 8})[seq]
        outs.append((pre, dec))
    idle_k = two.kv.k[0][1].float()                      # lane 1: never given a token
    assert idle_k.abs().max().item() == 0.0              # no slot was written (JAX parks
    #                                                      the prefill's 16 rows at the top)
    live_k = two.kv.k[0][0].float()                      # the chunk's 16 rows, padding too
    assert live_k[:, 16:].abs().max().item() == 0.0
    # the live lane sees B=2 instead of B=1: same route, rows independent
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-5)
        assert int(torch.argmax(a[-1])) == int(torch.argmax(b[-1]))


def _serving_ops(kv):
    """The lane operations of the serving engine: retention with LRU
    eviction, has_seq, seq_cp, seq_keep, lengths_array."""
    states = []
    for s, n in ((1, 5), (2, 7), (3, 2)):
        kv.seq_new(s)
        kv.lengths[kv.lane_of(s)] = n
    kv.mark_retained(2)
    kv.mark_retained(1)                 # 2 is the least recently retained
    kv.seq_new(4)                       # no free lane: evicts 2
    states.append((list(kv.seq_ids), [kv.has_seq(s) for s in (1, 2, 3, 4)],
                   sorted(kv.retained)))
    kv.unmark_retained(1)
    kv.seq_rm(4)
    kv.seq_cp(1, 5)                     # into the freed lane
    states.append((list(kv.seq_ids), list(kv.lengths)))
    kv.seq_keep(5)
    states.append((list(kv.seq_ids), list(kv.lengths), sorted(kv.retained),
                   [int(x) for x in np.asarray(kv.lengths_array())]))
    return states


def test_serving_lane_ops_match_jax():
    jcfg = jax_cfg(n_layers=1)
    ref = _serving_ops(JaxKVCache.create(jcfg, n_lanes=3, max_seq=16))
    kv = KVCache.create(torch_cfg(jcfg), n_lanes=3, max_seq=16)
    kv.k[0][0] = torch.randn(kv.k[0][0].shape).to(kv.k[0].dtype)   # lane 0 holds seq 1
    lane0 = kv.k[0][0].clone()
    got = _serving_ops(kv)
    assert got == ref
    # seq_cp copied the whole lane in place
    assert torch.equal(kv.k[0][kv.lane_of(5)], lane0)


# -- quantized caches ---------------------------------------------------------

# (quant, kv heads): q4 takes the head-pair layout for an even head count and
# the halves layout for an odd one
LAYOUTS = {"q8": ("q8", 2), "q4hp": ("q4", 2), "q4": ("q4", 3)}


def _qcfg(hkv: int):
    return jax_cfg(n_layers=2, n_kv_heads=hkv, n_heads=2 * hkv)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_quantized_create_matches_jax(layout):
    quant, hkv = LAYOUTS[layout]
    jcfg = _qcfg(hkv)
    jkv = JaxKVCache.create(jcfg, n_lanes=3, max_seq=32, quant=quant)
    tkv = KVCache.create(torch_cfg(jcfg), n_lanes=3, max_seq=32, quant=quant)
    assert tkv.quantized and jkv.quantized and tkv.n_lanes == jkv.n_lanes == 3
    for jc, tc in zip(jkv.k + jkv.v, tkv.k + tkv.v):
        for ja, ta in zip(jc, tc):
            assert tuple(ta.shape) == ja.shape
            assert str(ta.dtype).split(".")[-1] == str(ja.dtype)
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))   # zeros, scales ones
    assert tkv.nbytes() == sum(a.nbytes for c in jkv.k + jkv.v for a in c)
    bf16 = KVCache.create(torch_cfg(jcfg), n_lanes=3, max_seq=32)
    assert not bf16.quantized and bf16.n_lanes == 3


def _random_quantized(kv, jkv, rng):
    """Fill every layer of both caches with the same random quantized K/V."""
    from rrs_tpu.runtime import kv_codec as jkc

    for name in ("k", "v"):
        for li, (codes, sc) in enumerate(getattr(jkv, name)):
            hkv, s = sc.shape[1], sc.shape[3]
            x = rng.standard_normal((sc.shape[0], hkv, s, 64)).astype(np.float32)
            q, s_new = jkc.quantize_rows(jnp.asarray(x), jkc.kv_qmax(codes))
            if codes.dtype == jnp.uint8:
                q = jkc.pack_hp(q) if jkc.is_head_pair(codes, sc) else jkc.pack4(q)
            jc = (q, s_new[:, :, None, :])
            getattr(jkv, name)[li] = jc
            getattr(kv, name)[li] = tuple(torch.from_numpy(np.array(a)) for a in jc)


@pytest.mark.parametrize("t", [1, 6], ids=["decode", "prefill"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_quantized_store_matches_jax(layout, t):
    """The new rows' codes equal JAX's. Their scales do at prefill; at decode
    JAX blends the new scale into the lane (sc + (s_new - sc) * onehot), which
    moves it on a fresh lane (scales 1): held within 1e-5 relative."""
    from rrs_tpu.models.llama import _store_cache as jstore

    quant, hkv = LAYOUTS[layout]
    jcfg = _qcfg(hkv)
    rng = np.random.default_rng(5)
    jkv = JaxKVCache.create(jcfg, n_lanes=3, max_seq=32, quant=quant)
    tkv = KVCache.create(torch_cfg(jcfg), n_lanes=3, max_seq=32, quant=quant)
    new = rng.standard_normal((3, hkv, t, 64)).astype(np.float32)
    first = np.array([4, 17, -1], np.int32)                       # lane 2 has no token
    slots = np.where(first[:, None] < 0, 31, first[:, None] + np.arange(t, dtype=np.int32))
    mask = np.where(first[:, None] < 0, -1, slots).astype(np.int32)
    ref = jstore(jkv.k[0], jnp.asarray(new), jnp.asarray(slots), jnp.asarray(mask))
    starts = llama._layer_starts(llama._lane_slots(torch.from_numpy(slots), torch.from_numpy(mask)),
                                 32, t, ring=False)
    llama._store_cache(tkv.k[0], torch.from_numpy(new), starts)
    # the live lanes equal JAX's; the dead lane, which JAX parks in its top
    # slots (ROADMAP queue C3), is left as it was
    np.testing.assert_array_equal(tkv.k[0][0][:2].numpy(), np.asarray(ref[0])[:2])
    got_s, ref_s = tkv.k[0][1].numpy(), np.asarray(ref[1])
    if t > 1:
        np.testing.assert_array_equal(got_s[:2], ref_s[:2])
    else:
        np.testing.assert_allclose(got_s[:2], ref_s[:2], rtol=1e-5, atol=0)
    assert not tkv.k[0][0][2].numpy().any() and (got_s[2] == 1).all()
    # the written scales are the quantizer's own
    from rrs_tpu_torch.runtime import kv_codec

    _, s_new = kv_codec.quantize_rows(torch.from_numpy(new), kv_codec.kv_qmax(tkv.k[0][0]))
    np.testing.assert_array_equal(got_s[1, :, 0, 17:17 + t], s_new[1].numpy())
    # where JAX parks the dead lane's rows (its decode blend within 1e-5)
    np.testing.assert_allclose(ref_s[2, :, 0, 32 - t:], s_new[2].numpy(), rtol=1e-5, atol=0)


def test_jax_decode_scale_blend_bound():
    """The JAX quirk the port does not copy: 16 fresh decode rows a step
    (q8, B=2, H=8, D=128) stored by JAX's _store_cache keep their codes, but
    the blended scale lands within 2.6e-6 relative of the quantizer's, not
    on it; the port stores the quantizer's scale exactly."""
    from rrs_tpu.models.llama import _store_cache as jstore
    from rrs_tpu.runtime import kv_codec as jkc
    from rrs_tpu_torch.runtime import kv_codec

    rng = np.random.default_rng(0)
    b, h, s, d = 2, 8, 32, 128
    jcache = (jnp.zeros((b, h, s, d), jnp.int8), jnp.ones((b, h, 1, s), jnp.float32))
    tcache = (torch.zeros((b, h, s, d), dtype=torch.int8), torch.ones((b, h, 1, s)))
    worst = 0.0
    for step in range(8):
        new = rng.standard_normal((b, h, 1, d)).astype(np.float32)
        slots = np.full((b, 1), step, np.int32)
        jcache = jstore(jcache, jnp.asarray(new), jnp.asarray(slots), jnp.asarray(slots))
        llama._store_cache(tcache, torch.from_numpy(new), [step] * b)
        q, s_new = kv_codec.quantize_rows(torch.from_numpy(new), 127.0)
        np.testing.assert_array_equal(np.asarray(jcache[0])[:, :, step], q[:, :, 0].numpy())
        np.testing.assert_array_equal(tcache[0][:, :, step].numpy(), q[:, :, 0].numpy())
        np.testing.assert_array_equal(tcache[1][:, :, 0, step].numpy(), s_new[:, :, 0].numpy())
        _, js = jkc.quantize_rows(jnp.asarray(new), 127.0)
        np.testing.assert_array_equal(np.asarray(js), s_new.numpy())
        got = np.asarray(jcache[1])[:, :, 0, step]
        worst = max(worst, float(np.max(np.abs(got - s_new[:, :, 0].numpy())
                                        / s_new[:, :, 0].numpy())))
    assert worst <= 2.6e-6


def test_quantized_seq_cp_matches_jax():
    jcfg = _qcfg(2)
    rng = np.random.default_rng(6)
    jkv = JaxKVCache.create(jcfg, n_lanes=3, max_seq=16, quant="q4")
    tkv = KVCache.create(torch_cfg(jcfg), n_lanes=3, max_seq=16, quant="q4")
    _random_quantized(tkv, jkv, rng)
    for kv in (jkv, tkv):
        kv.seq_new(1)
        kv.lengths[0] = 9
        kv.seq_new(2)
        kv.seq_rm(2)
        kv.seq_cp(1, 3)
    assert tkv.seq_ids == jkv.seq_ids and tkv.lengths == jkv.lengths
    for jc, tc in zip(jkv.k + jkv.v, tkv.k + tkv.v):
        for ja, ta in zip(jc, tc):
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tkv.v[1][1][1].numpy(), tkv.v[1][1][0].numpy())


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_quantized_seq_shift_matches_jax(layout):
    """Drop cells [1, 10) of lane 1: K is dequantized, rolled, rotated and
    requantized, within one quantization step of JAX's per element (the two
    round the rotation's f32 result at either side of a half-way point); V
    codes and scales are only rolled, and equal JAX's."""
    from rrs_tpu.runtime import kv_codec as jkc
    from rrs_tpu_torch.runtime import kv_codec as tkc

    quant, hkv = LAYOUTS[layout]
    jcfg = _qcfg(hkv)
    cfg = torch_cfg(jcfg)
    rng = np.random.default_rng(7)
    jkv = JaxKVCache.create(jcfg, n_lanes=2, max_seq=32, quant=quant)
    tkv = KVCache.create(cfg, n_lanes=2, max_seq=32, quant=quant)
    _random_quantized(tkv, jkv, rng)
    lane0 = [t.clone() for t in tkv.k[0]]
    for kv in (jkv, tkv):
        kv.seq_new(7)
        kv.seq_new(8)
        kv.lengths[1] = 30
    jkv.seq_shift(jcfg, 8, 1, 9)
    tkv.seq_shift(cfg, 8, 1, 9)
    assert tkv.lengths == jkv.lengths == [0, 21]
    for li in range(cfg.n_layers):
        got = tkc.dequantize(*tkv.k[li]).numpy()
        ref = np.asarray(jkc.dequantize(*jkv.k[li]))
        step = np.maximum(tkv.k[li][1].numpy(), np.asarray(jkv.k[li][1]))   # [B, H, 1, S]
        assert (np.abs(got - ref) <= 1.0001 * step.transpose(0, 1, 3, 2)).all()
        for ja, ta in zip(jkv.v[li], tkv.v[li]):
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    # the other lane stays as it was
    for before, after in zip(lane0, tkv.k[0]):
        np.testing.assert_array_equal(after[0].numpy(), before[0].numpy())


def test_padded_lanes_keep_live_rows_where_jax_overwrites_them():
    """ROADMAP C3: four lanes of a 512-slot cache, prompts of 40 / 300 / 100 /
    20 tokens prefilled in turn, then one batched decode step. The 300-token
    prefill (a 512-row bucket) and the 100-token one (256 rows) leave the
    other lanes out; the port writes nothing for them, so every lane's decode
    equals its sequence decoded alone. The JAX package parks a left-out
    lane's rows in its cache's top slots, over all of lane 0's rows and lane
    1's rows 256-299, so its lanes 0 and 1 decode other logits (held far
    apart), lanes 2 and 3 the same. With room in the cache (1,024 slots) the
    two packages agree on every lane."""
    from rrs_tpu.models import llama as jllama
    from rrs_tpu.runtime.context import InferenceContext as JaxContext

    from test_torch_common import exact_jit, weights_tree

    jcfg = jax_cfg(n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, head_dim=64, n_ff=512,
                   vocab_size=512, context_length=1024)
    jw = jllama.random_weights(jcfg, seed=3)
    cfg = torch_cfg(jcfg)
    w = llama.weights_from_numpy(cfg, weights_tree(jw), device="cpu")
    rng = np.random.default_rng(25)
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist() for n in (40, 300, 100, 20)]
    feed = [7, 8, 9, 10]

    def batched(ctx):
        seqs = [ctx.new_sequence() for _ in prompts]
        for s, p in zip(seqs, prompts):
            ctx.prefill(s, p)
        out = ctx.decode(dict(zip(seqs, feed)))
        return [np.asarray(out[s], np.float32) for s in seqs]

    def alone(ctx):
        rows = []
        for p, f in zip(prompts, feed):
            s = ctx.new_sequence()
            ctx.prefill(s, p)
            rows.append(np.asarray(ctx.decode({s: f})[s], np.float32))
            ctx.kv.seq_rm(s)
        return rows

    port = batched(InferenceContext(cfg, w, n_lanes=4, max_seq=512, device="cpu"))
    ref = alone(InferenceContext(cfg, w, n_lanes=4, max_seq=512, device="cpu"))
    for got, want in zip(port, ref):
        np.testing.assert_array_equal(got, want)
    with exact_jit():
        jax512 = batched(JaxContext(jcfg, jw, n_lanes=4, max_seq=512))
        jax1024 = batched(JaxContext(jcfg, jw, n_lanes=4, max_seq=1024))
    gaps = [float(np.abs(a - b).max()) for a, b in zip(jax512, ref)]
    assert min(gaps[:2]) > 0.2 and max(gaps[2:]) <= 3e-2, gaps
    port1024 = batched(InferenceContext(cfg, w, n_lanes=4, max_seq=1024, device="cpu"))
    for got, want in zip(port1024, jax1024):
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-2)
