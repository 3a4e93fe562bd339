"""The split-S plan of B7 (``flash_attention_q4hp``) and B8
(``flash_attention_q4``), on the CPU: which tiles each split owns, how many
blocks the decode body launches and the scratch the wrapper allocates; a
plain torch emulation of the decode body's splits, partials and fixed-order
combine (f32, without the kernel's bf16 rounding of P v_s) against the JAX
package's Pallas kernels in interpret mode, within the JAX tests' q4
tolerance; and the kernels' int4 -> bf16 bit trick on every byte value of
both layouts (and on words of four different bytes)."""

from __future__ import annotations

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu_torch.ops import attn_split, splitk
from rrs_tpu_torch.ops import flash_attention as tfa
from rrs_tpu_torch.runtime import kv_codec as tkc

from test_torch_flash_attention_kvq import CODECS, OPTIONS, _inputs

Q4 = ("q4hp", "q4")
# (B, Hkv, H, T, S, D): served decode of qwen3-4b, generate, gpt-oss's ring,
# Qwen3-30B-A3B, small and odd shapes
SHAPES = [(4, 8, 32, 1, 4096, 128), (1, 8, 32, 1, 1024, 128), (2, 8, 64, 1, 640, 64),
          (4, 4, 32, 1, 4096, 128), (1, 2, 4, 3, 128, 64), (1, 2, 16, 1, 100, 256),
          (8, 2, 8, 2, 33, 64), (64, 8, 32, 1, 4096, 128), (1, 2, 2, 1, 64, 64),
          (3, 3, 9, 1, 2000, 128), (4, 8, 32, 1024, 4096, 128), (1, 2, 8, 9, 160, 128),
          (1, 2, 16, 2, 32768, 128), (1, 4, 8, 8, 131072, 64)]


def _plan(codec, b, hkv, h, t, s, d):
    heads = 2 if codec == "q4hp" else 1
    return attn_split.plan(b, hkv // heads, heads, t, h // hkv, s, d), hkv // heads, heads


@pytest.mark.parametrize("codec", Q4)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_invariants(codec, shape):
    b, hkv, h, t, s, d = shape
    p, planes, heads = _plan(codec, b, hkv, h, t, s, d)
    tiles = -(-s // attn_split.TILE)
    assert p.decode == (t * (h // hkv) <= attn_split.DECODE_ROWS)
    if not p.decode:
        assert (p.n_split, p.scratch_elems, p.counters) == (1, 0, 0)
        return
    # splits of whole tiles covering [0, S) exactly once
    owned = [min(tiles, (i + 1) * p.split_tiles) - i * p.split_tiles for i in range(p.n_split)]
    assert all(n >= 1 for n in owned) and sum(owned) == tiles
    assert p.split_tiles * attn_split.TILE * p.n_split >= s
    # at least MIN_BLOCKS blocks wherever S has enough tiles and the combine
    # room for them; else a tile a split
    rows = heads * t * (h // hkv)
    assert p.n_split * rows <= attn_split.MAX_PARTIALS
    need = -(-attn_split.MIN_BLOCKS // (b * planes))
    if tiles >= need and need * rows <= attn_split.MAX_PARTIALS // 2:
        assert b * planes * p.n_split >= attn_split.MIN_BLOCKS
    elif tiles < need:
        assert p.n_split == tiles
    # f32 partials: (D sums, max, denominator) per (lane, plane, split, row)
    if p.n_split > 1:
        assert p.scratch_elems == b * planes * p.n_split * rows * (d + 2)
        assert p.counters == b * planes
    else:
        assert (p.scratch_elems, p.counters) == (0, 0)


def test_plan_reads_shapes_only():
    """The plan takes integers only (never positions), so the wrapper needs
    no host sync and a launch's shape is fixed by the shapes."""
    params = inspect.signature(attn_split.plan).parameters
    assert all(v.annotation in (int, "int") for v in params.values())
    assert attn_split.plan(4, 4, 2, 1, 4, 4096, 128) == attn_split.plan(4, 4, 2, 1, 4, 4096, 128)
    with pytest.raises(dataclasses.FrozenInstanceError):
        attn_split.plan(4, 4, 2, 1, 4, 4096, 128).n_split = 1


def test_buffers():
    dev = torch.device("cpu")
    one = attn_split.plan(1, 1, 1, 1, 2, 64, 64)
    assert one.n_split == 1 and attn_split.buffers(one, dev) == (None, None)
    p = attn_split.plan(4, 4, 2, 1, 4, 4096, 128)
    scratch, counters = attn_split.buffers(p, dev)
    assert scratch.numel() == p.scratch_elems and scratch.dtype == torch.float32
    assert counters.numel() >= p.counters and counters.dtype == torch.int32
    assert int(counters.abs().sum()) == 0
    assert attn_split.buffers(p, dev)[1] is counters       # one buffer per device,
    assert splitk.counters(dev, 1) is counters             # the split-K matmuls' one


def emulate_decode(q, caches, pos, scale, softcap=0.0, window=0, sinks=None, alibi=0.0,
                   codec="q4hp"):
    """The decode body's algorithm in f32: each split's slots clipped at its
    lane's live length, its rows' (max, denominator, sums) partials, then the
    splits merged in split order with the sink in the merged denominator."""
    b, t, h, d = q.shape
    k = tkc.dequantize(caches[0], caches[1])
    v = tkc.dequantize(caches[2], caches[3])
    hkv, s = k.shape[1], k.shape[2]
    g = h // hkv
    p, _, _ = _plan(codec, b, hkv, h, t, s, d)
    assert p.decode
    tile = attn_split.TILE
    slopes = torch.from_numpy(tfa.alibi_slopes_np(h, alibi)) if alibi else torch.zeros(h)
    ninf = float("-inf")
    out = torch.zeros((b, t, h, d))
    for lane in range(b):
        lp = pos[lane].to(torch.int64)
        n_slots = s if window > 0 else min(s, int(lp.max()) + 1)
        for kvh in range(hkv):
            heads = torch.arange(kvh * g, (kvh + 1) * g)
            qh = q[lane][:, heads].float()                          # [T, G, D]
            parts = []
            for i in range(p.n_split):
                lo = i * p.split_tiles * tile
                hi = min(n_slots, lo + p.split_tiles * tile)
                if lo >= hi:
                    parts.append((torch.full((t, g), ninf), torch.zeros((t, g)), None))
                    continue
                slot = torch.arange(lo, hi)
                sc = torch.einsum("tgd,sd->tgs", qh, k[lane, kvh, lo:hi]) * scale
                if softcap:
                    sc = torch.tanh(sc / softcap) * softcap
                if window > 0:
                    real = lp[:, None] - torch.remainder(lp[:, None] - slot, s)
                    valid = (real >= 0) & (real > lp[:, None] - window)
                else:
                    real = slot.expand(t, -1)
                    valid = slot[None, :] <= lp[:, None]
                sc = sc + slopes[heads][None, :, None] * (real - lp[:, None]).float()[:, None]
                sc = torch.where(valid[:, None, :], sc, torch.tensor(ninf))
                m = sc.amax(-1)
                e = torch.exp(sc - torch.where(m == ninf, 0.0, m)[..., None])
                parts.append((m, e.sum(-1), torch.einsum("tgs,sd->tgd", e, v[lane, kvh, lo:hi])))
            big_m = torch.stack([m for m, _, _ in parts]).amax(0)
            den = torch.zeros((t, g))
            acc = torch.zeros((t, g, d))
            for m, l, a in parts:                                   # split order
                f = torch.where(m == ninf, 0.0, torch.exp(m - big_m))
                den = den + l * f
                if a is not None:
                    acc = acc + f[..., None] * a
            if sinks is not None:
                den = den + torch.exp(torch.as_tensor(sinks)[heads][None, :] - big_m)
            live = big_m != ninf
            res = torch.where(live[..., None], acc / den.clamp_min(1e-30)[..., None],
                              torch.zeros(()))
            out[lane][:, heads] = res
    return out


EXTRA = {
    "past_live_length": dict(s=512, start=60),
    "dead_lane_sinks": dict(b=2, s=384, sinks=True),
    "ring_window_tiles": dict(s=192, window=40, start=500, sinks=True),
}


@pytest.mark.parametrize("case", sorted(OPTIONS) + sorted(EXTRA))
@pytest.mark.parametrize("codec", Q4)
def test_split_emulation_matches_jax_kernel(codec, case):
    jfn, _, tol = CODECS[codec]
    c = OPTIONS.get(case) or EXTRA[case]
    q, caches, pos = _inputs(codec, **c)
    h = q.shape[2]
    scale = 1.0 / np.sqrt(q.shape[-1])
    kw = dict(softcap=c.get("softcap", 0.0), window=c.get("window", 0),
              alibi=c.get("alibi", 0.0))
    sinks = np.linspace(-1.0, 1.0, h).astype(np.float32) if c.get("sinks") else None
    ref = np.asarray(jfn(jnp.asarray(q), *(jnp.asarray(a) for a in caches), jnp.asarray(pos),
                         scale, interpret=True,
                         sinks=None if sinks is None else jnp.asarray(sinks), **kw))
    p, _, _ = _plan(codec, q.shape[0], caches[1].shape[1], h, q.shape[1], caches[1].shape[3],
                    q.shape[3])
    assert p.n_split > 1                                # every case splits S
    got = emulate_decode(torch.from_numpy(q), [torch.from_numpy(a) for a in caches],
                         torch.from_numpy(pos), scale,
                         sinks=None if sinks is None else torch.from_numpy(sinks), codec=codec,
                         **kw).numpy()
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    assert np.all(got[pos < 0] == 0.0)                 # padded rows and dead lanes: exactly 0


def _bf16_value(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def byte_perm(x: np.ndarray, y: int, sel: int) -> np.ndarray:
    """CUDA's ``__byte_perm``: result byte i is byte (sel >> 4i) & 7 of the
    pair (x bytes 0-3, y bytes 4-7)."""
    src = [(x >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    src += [np.full_like(x, (y >> (8 * i)) & 0xFF) for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << np.uint32(8 * i) for i in range(4))


def kernel_codes(words: np.ndarray, shift: int, halves: bool) -> np.ndarray:
    """``codes4`` of csrc/flash_attention_q4.cu on uint32 words: the nibbles
    at ``shift`` of the 4 bytes (+8-biased, after u ^ 8 for two's
    complement), each put under the byte 0x43 (bf16 128 + u) by a byte
    permute and 136 subtracted (exact in bf16): 4 codes per word, byte
    order."""
    x = (words >> np.uint32(shift)) & np.uint32(0x0F0F0F0F)
    if halves:
        x ^= np.uint32(0x08080808)
    out = []
    for sel in (0x5140, 0x7362):                      # bytes 0-1, then bytes 2-3
        pair = byte_perm(x, 0x43434343, sel)
        for half in (pair & np.uint32(0xFFFF), pair >> np.uint32(16)):
            val = _bf16_value(half) - np.float32(136.0)
            assert np.all(val.view(np.uint32) & np.uint32(0xFFFF) == 0)     # exact in bf16
            out.append(val)
    return np.stack(out, axis=-1)


def test_bf16_bit_trick_every_byte():
    bytes_ = np.arange(256, dtype=np.uint8)
    words = bytes_.astype(np.uint32) * np.uint32(0x01010101)     # the byte in all 4 bytes
    # head pair: byte (s, d) holds head 2j's code + 8 low and 2j+1's high
    hp = tkc.unpack_hp(torch.from_numpy(bytes_.reshape(1, 256, 1))).numpy()   # [2, 256, 1]
    for sub in range(2):
        got = kernel_codes(words, 4 * sub, halves=False)
        assert np.array_equal(got, np.repeat(hp[sub, :, 0, None], 4, axis=1).astype(np.float32))
    # halves: byte d holds element d low and d + D/2 high, two's complement
    h4 = tkc.unpack4(torch.from_numpy(bytes_.reshape(256, 1))).numpy()           # [256, 2]
    for half in range(2):
        got = kernel_codes(words, 4 * half, halves=True)
        assert np.array_equal(got, np.repeat(h4[:, half, None], 4, axis=1).astype(np.float32))
    # four different bytes in one word land in byte order
    rng = np.random.default_rng(0)
    quads = rng.integers(0, 256, (64, 4), dtype=np.uint8)
    words = quads.view(np.uint32).reshape(64)
    for sub in range(2):
        want = tkc.unpack_hp(torch.from_numpy(quads.reshape(1, 64, 4))).numpy()[sub]
        assert np.array_equal(kernel_codes(words, 4 * sub, halves=False), want)
