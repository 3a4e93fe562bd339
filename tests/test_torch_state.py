"""Session state files of rrs_tpu_torch against rrs_tpu.runtime.state: save
and restore round trips over bf16, q8, q4 head-pair and q4 halves caches (a
sequence and the whole context), a sequence file written by either package
loaded into the other with equal dequantized lanes, and the header checks."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.runtime import kv_codec as jkc
from rrs_tpu.runtime import state as jstate
from rrs_tpu.runtime.kv_cache import KVCache as JaxKVCache
from rrs_tpu_torch.runtime import kv_codec as tkc
from rrs_tpu_torch.runtime import state as tstate
from rrs_tpu_torch.runtime.kv_cache import KVCache

from test_torch_common import jax_cfg, torch_cfg

# (quant, kv heads): q4 with an even head count is head-pair, with an odd one halves
LAYOUTS = {"bf16": ("none", 2), "q8": ("q8", 2), "q4hp": ("q4", 2), "q4": ("q4", 3)}
S = 24


def _ctx(kv, cfg):
    """The parts of an inference context the state functions use."""
    ctx = types.SimpleNamespace(cfg=cfg, kv=kv, _next_seq_id=100)

    def new_sequence():
        seq = ctx._next_seq_id
        ctx._next_seq_id += 1
        kv.seq_new(seq)
        return seq

    ctx.new_sequence = new_sequence
    return ctx


def _fill(kv, rng, to_device):
    """Random K/V in every layer of ``kv`` (quantized with the JAX codec)."""
    for name in ("k", "v"):
        caches = getattr(kv, name)
        for li, c in enumerate(caches):
            if not isinstance(c, tuple):
                x = rng.standard_normal(tuple(c.shape)).astype(np.float32)
                caches[li] = to_device(jnp.asarray(x, jnp.bfloat16))
                continue
            codes, sc = c
            x = jnp.asarray(rng.standard_normal(
                (sc.shape[0], sc.shape[1], S, 64)).astype(np.float32))
            u8 = str(codes.dtype).endswith("uint8")
            q, s_new = jkc.quantize_rows(x, 7.0 if u8 else 127.0)
            if u8:
                q = jkc.pack_hp(q) if codes.shape[1] * 2 == sc.shape[1] else jkc.pack4(q)
            caches[li] = (to_device(q), to_device(s_new[:, :, None, :]))


def _to_torch(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _lanes(kv, lane, n, to_np):
    """Every layer's K and V of one lane, dequantized to f32 [H, n, D]."""
    out = []
    for c in kv.k + kv.v:
        if isinstance(c, tuple):
            d = to_np(c[0][lane]), to_np(c[1][lane])
            out.append(np.asarray(jkc.dequantize(jnp.asarray(d[0])[None],
                                                 jnp.asarray(d[1])[None]))[0, :, :n])
        else:
            out.append(np.asarray(to_np(c[lane]), np.float32)[:, :n])
    return out


def _pair(layout, seed):
    quant, hkv = LAYOUTS[layout]
    jcfg = jax_cfg(n_layers=2, n_kv_heads=hkv, n_heads=2 * hkv)
    cfg = torch_cfg(jcfg)
    jkv = JaxKVCache.create(jcfg, n_lanes=2, max_seq=S, quant=quant)
    tkv = KVCache.create(cfg, n_lanes=2, max_seq=S, quant=quant)
    _fill(jkv, np.random.default_rng(seed), lambda a: a)
    _fill(tkv, np.random.default_rng(seed), _to_torch)
    return _ctx(jkv, jcfg), _ctx(tkv, cfg)


def _t_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sequence_roundtrip(layout, tmp_path):
    """Save a 19-token lane, free it, restore it into a fresh lane: codes come
    back equal and scales within 1e-6 (save dequantizes, restore
    requantizes); the file carries the tokens."""
    _, ctx = _pair(layout, seed=1)
    seq = ctx.new_sequence()
    lane = ctx.kv.lane_of(seq)
    ctx.kv.lengths[lane] = 19
    before = [tuple(t[lane].clone() for t in (c if isinstance(c, tuple) else (c,)))
              for c in ctx.kv.k + ctx.kv.v]
    path = tmp_path / "slot0.rrsstate"                 # written as named, no .npz added
    n_bytes = tstate.save_sequence(ctx, seq, path, tokens=list(range(19)))
    assert path.exists() and n_bytes == path.stat().st_size > 0
    ctx.kv.seq_rm(seq)
    seq2, tokens = tstate.load_sequence(ctx, path)
    lane2 = ctx.kv.lane_of(seq2)
    assert tokens == list(range(19)) and ctx.kv.lengths[lane2] == 19 and seq2 != seq
    for old, c in zip(before, ctx.kv.k + ctx.kv.v):
        new = tuple(t[lane2] for t in (c if isinstance(c, tuple) else (c,)))
        np.testing.assert_array_equal(_t_np(new[0][..., :19, :]), _t_np(old[0][..., :19, :]))
        if len(new) == 2:
            np.testing.assert_allclose(new[1][..., :19].numpy(), old[1][..., :19].numpy(),
                                       rtol=1e-6, atol=0)


@pytest.mark.parametrize("layout", ["bf16", "q4hp"])
def test_full_state_roundtrip(layout, tmp_path):
    _, ctx = _pair(layout, seed=2)
    for seq, n in ((5, 11), (6, 17)):
        ctx.kv.seq_new(seq)
        ctx.kv.lengths[ctx.kv.lane_of(seq)] = n
    want = [_lanes(ctx.kv, lane, n, _t_np) for lane, n in ((0, 11), (1, 17))]
    tstate.save_state(ctx, tmp_path / "all.npz")
    _, fresh = _pair(layout, seed=3)
    tstate.load_state(fresh, tmp_path / "all.npz")
    assert fresh.kv.lengths == [11, 17] and fresh.kv.seq_ids == [5, 6]
    assert fresh._next_seq_id == 100                     # already past the restored ids
    for lane, n in ((0, 11), (1, 17)):
        for got, ref in zip(_lanes(fresh.kv, lane, n, _t_np), want[lane]):
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sequence_file_crosses_packages(layout, direction, tmp_path):
    jctx, tctx = _pair(layout, seed=4)
    src, dst = (jctx, tctx) if direction == "jax_to_torch" else (tctx, jctx)
    save = jstate.save_sequence if src is jctx else tstate.save_sequence
    load = tstate.load_sequence if dst is tctx else jstate.load_sequence
    seq = src.new_sequence()
    src.kv.lengths[src.kv.lane_of(seq)] = 15
    path = tmp_path / "seq.npz"
    save(src, seq, path, tokens=[3, 1, 4])
    seq2, tokens = load(dst, path)
    assert tokens == [3, 1, 4] and dst.kv.lengths[dst.kv.lane_of(seq2)] == 15
    np_of = lambda ctx: _t_np if ctx is tctx else np.asarray      # noqa: E731
    got = _lanes(dst.kv, dst.kv.lane_of(seq2), 15, np_of(dst))
    ref = _lanes(src.kv, src.kv.lane_of(seq), 15, np_of(src))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7)


def test_state_header_checks(tmp_path):
    _, ctx = _pair("q8", seed=5)
    seq = ctx.new_sequence()
    ctx.kv.lengths[ctx.kv.lane_of(seq)] = 4
    tstate.save_sequence(ctx, seq, tmp_path / "s.npz")
    _, other = _pair("q4", seed=5)                       # 3 kv heads, not 2
    with pytest.raises(ValueError, match="mismatch"):
        tstate.load_sequence(other, tmp_path / "s.npz")
    np.savez(tmp_path / "bad.npz", __meta__=np.frombuffer(b'{"magic": "x"}', np.uint8))
    with pytest.raises(ValueError, match="not an rrs_tpu state file"):
        tstate.load_sequence(ctx, tmp_path / "bad.npz")
    assert tkc.kv_qmax(ctx.kv.k[0][0]) == 127.0
