"""The split-S plan of the attention kernels B3 (``flash_attention``, bf16
rows), B6 (``flash_attention_q8``), B7 (``flash_attention_q4hp``) and B8
(``flash_attention_q4``), on the CPU: which tiles each split owns, how many
blocks the decode body launches and the scratch the wrapper allocates; the
plan's constants and codec ids against the kernel source's; a plain torch
emulation of the decode body's splits, partials and fixed-order combine
(f32, without the kernel's bf16 rounding of P v_s) against the JAX
package's Pallas kernels in interpret mode, within the JAX tests'
tolerances; the error that rounding P v_s to bf16 adds, against its bound;
and the kernels' int8 -> bf16 and int4 -> bf16 bit tricks on every byte
value (and on words of four different bytes)."""

from __future__ import annotations

import dataclasses
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.ops import flash_attention as jfa
from rrs_tpu_torch import kernels
from rrs_tpu_torch.ops import attn_split, splitk
from rrs_tpu_torch.ops import flash_attention as tfa
from rrs_tpu_torch.runtime import kv_codec as tkc

from test_torch_flash_attention_kvq import CODECS, OPTIONS, _inputs

# the cache codecs of the four kernels
ALL = ("bf16", "q8", "q4hp", "q4")
# the JAX kernel of bf16 rows and its tests' tolerance (tests/test_flash_attention.py)
BF16_JAX = (jfa.flash_attention, 2e-5)
SOURCE = Path(kernels.CSRC) / "attention_sm90.cuh"
# (B, Hkv, H, T, S, D): served decode of qwen3-4b, generate, gpt-oss's ring,
# Qwen3-30B-A3B, small and odd shapes
SHAPES = [(4, 8, 32, 1, 4096, 128), (1, 8, 32, 1, 1024, 128), (2, 8, 64, 1, 640, 64),
          (4, 4, 32, 1, 4096, 128), (1, 2, 4, 3, 128, 64), (1, 2, 16, 1, 100, 256),
          (8, 2, 8, 2, 33, 64), (64, 8, 32, 1, 4096, 128), (1, 2, 2, 1, 64, 64),
          (3, 3, 9, 1, 2000, 128), (4, 8, 32, 1024, 4096, 128), (1, 2, 8, 9, 160, 128),
          (1, 2, 16, 2, 32768, 128), (1, 4, 8, 8, 131072, 64)]


def _plan(codec, b, hkv, h, t, s, d):
    heads = attn_split.HEADS_PER_PLANE[codec]
    return attn_split.plan(codec, b, hkv, t, h // hkv, s, d), hkv // heads, heads


@pytest.mark.parametrize("codec", ALL)
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
    """The plan takes the cache codec and integers only (never positions),
    so the wrapper needs no host sync and a launch's shape is fixed by the
    shapes."""
    params = list(inspect.signature(attn_split.plan).parameters.values())
    assert params[0].name == "codec" and params[0].annotation in (str, "str")
    assert all(v.annotation in (int, "int") for v in params[1:])
    assert attn_split.plan("q4hp", 4, 8, 1, 4, 4096, 128) == \
        attn_split.plan("q4hp", 4, 8, 1, 4, 4096, 128)
    with pytest.raises(dataclasses.FrozenInstanceError):
        attn_split.plan("q4hp", 4, 8, 1, 4, 4096, 128).n_split = 1
    # one kv head a plane: bf16 and q8 rows plan as halves-packed int4
    for codec in ("bf16", "q8"):
        assert attn_split.plan(codec, 4, 8, 1, 4, 4096, 128) == \
            attn_split.plan("q4", 4, 8, 1, 4, 4096, 128)


def _source_int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text()).group(1))


def test_plan_constants_match_the_kernel_source():
    """The plan's constants, each codec's kv heads a plane and codec id, and
    the C entry's argument count are the kernel source's."""
    src = SOURCE.read_text()
    assert _source_int("kTile") == attn_split.TILE
    assert _source_int("kDecodeRows") == attn_split.DECODE_ROWS
    assert _source_int("kMaxPartials") == attn_split.MAX_PARTIALS
    enum = dict(re.findall(r"(k\w+) = (\d)", re.search(r"enum Codec \{([^}]*)\}", src).group(1)))
    names = {"q8": "kQ8", "q4hp": "kQ4HeadPair", "q4": "kQ4Halves", "bf16": "kBF16"}
    assert {codec: int(enum[names[codec]]) for codec in ALL} == \
        {codec: cid for codec, cid in tfa._CODECS.values()}
    pair = re.search(r"heads_per_plane\(int c\) \{ return c == (\w+) \? 2 : 1; \}", src)
    assert {codec: 2 if names[codec] == pair.group(1) else 1 for codec in ALL} == \
        attn_split.HEADS_PER_PLANE
    entry = (Path(kernels.CSRC) / "flash_attention.cu").read_text()
    params = re.search(r"int rrs_flash_attention\(([^)]*)\)", entry).group(1)
    assert params.count(",") + 1 == len(kernels.SIGNATURES["rrs_flash_attention"])


def test_buffers():
    dev = torch.device("cpu")
    one = attn_split.plan("q4", 1, 1, 1, 2, 64, 64)
    assert one.n_split == 1 and attn_split.buffers(one, dev) == (None, None)
    p = attn_split.plan("q4hp", 4, 8, 1, 4, 4096, 128)
    scratch, counters = attn_split.buffers(p, dev)
    assert scratch.numel() == p.scratch_elems and scratch.dtype == torch.float32
    assert counters.numel() >= p.counters and counters.dtype == torch.int32
    assert int(counters.abs().sum()) == 0
    assert attn_split.buffers(p, dev)[1] is counters       # one buffer per device,
    assert splitk.counters(dev, 1) is counters             # the split-K matmuls' one


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def emulate_decode(q, caches, pos, scale, softcap=0.0, window=0, sinks=None, alibi=0.0,
                   codec="q4hp", round_p=False):
    """The decode body's algorithm in f32: each split's slots clipped at its
    lane's live length, its rows' (max, denominator, sums) partials, then the
    splits merged in split order with the sink in the merged denominator.
    ``caches``: (k, v) bf16 rows or (k codes, k scales, v codes, v scales).
    ``round_p``: round P v_s to bf16 before it meets the V codes (bf16 rows:
    P alone), as the kernel's P.V operand does."""
    b, t, h, d = q.shape
    if codec == "bf16":
        k, v_codes = caches[0].float(), caches[1].float()
        v_scale = torch.ones(v_codes.shape[:3])
    else:
        k = tkc.dequantize(caches[0], caches[1])
        v_codes = tkc.dequantize(caches[2], torch.ones_like(caches[3]))
        v_scale = caches[3][:, :, 0, :]
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
                pv = e * v_scale[lane, kvh, lo:hi]
                if round_p:
                    pv = _bf16(pv)
                parts.append((m, e.sum(-1), torch.einsum("tgs,sd->tgd", pv,
                                                         v_codes[lane, kvh, lo:hi])))
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


def _case_inputs(codec, c):
    """q (bf16 values), the codec's caches and positions of an OPTIONS /
    EXTRA case: the quantized codes of the kvq tests, or for bf16 rows the
    same draws rounded to bf16."""
    q, caches, pos = _inputs("q8" if codec == "bf16" else codec, **c)
    q = _bf16(torch.from_numpy(q)).numpy()
    if codec == "bf16":
        rng = np.random.default_rng(c.get("seed", 0) + 1)
        shape = caches[0].shape
        caches = [_bf16(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))).numpy()
                  for _ in range(2)]
    return q, caches, pos


def _case_kw(c, h):
    kw = dict(softcap=c.get("softcap", 0.0), window=c.get("window", 0),
              alibi=c.get("alibi", 0.0))
    sinks = np.linspace(-1.0, 1.0, h).astype(np.float32) if c.get("sinks") else None
    return kw, sinks


@pytest.mark.parametrize("case", sorted(OPTIONS) + sorted(EXTRA))
@pytest.mark.parametrize("codec", ALL)
def test_split_emulation_matches_jax_kernel(codec, case):
    jfn, tol = BF16_JAX if codec == "bf16" else (CODECS[codec][0], CODECS[codec][2])
    c = OPTIONS.get(case) or EXTRA[case]
    q, caches, pos = _case_inputs(codec, c)
    h = q.shape[2]
    scale = 1.0 / np.sqrt(q.shape[-1])
    kw, sinks = _case_kw(c, h)
    ref = np.asarray(jfn(jnp.asarray(q), *(jnp.asarray(a) for a in caches), jnp.asarray(pos),
                         scale, interpret=True,
                         sinks=None if sinks is None else jnp.asarray(sinks), **kw))
    hkv, s = caches[0].shape[1], caches[0].shape[2]
    if codec != "bf16":
        hkv, s = caches[1].shape[1], caches[1].shape[3]
    p, _, _ = _plan(codec, q.shape[0], hkv, h, q.shape[1], s, q.shape[3])
    assert p.n_split > 1                                # every case splits S
    got = emulate_decode(torch.from_numpy(q), [torch.from_numpy(a) for a in caches],
                         torch.from_numpy(pos), scale,
                         sinks=None if sinks is None else torch.from_numpy(sinks), codec=codec,
                         **kw).numpy()
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    assert np.all(got[pos < 0] == 0.0)                 # padded rows and dead lanes: exactly 0


@pytest.mark.parametrize("case", sorted(OPTIONS) + sorted(EXTRA))
@pytest.mark.parametrize("codec", ALL)
def test_p_rounding_stays_within_its_bound(codec, case):
    """Rounding P v_s to bf16 (8 significant bits, round to nearest: a
    relative error <= 2^-8 a product) is the kernels' only rounding beyond
    the f32 plain version's: q, bf16 rows and codes are exact in bf16. So
    each output is within 2^-8 * sum_s p_s |v_s| (p the softmax weights, v
    the dequantized V) of the plain version, which ``attention_ref`` over
    |V| computes."""
    c = OPTIONS.get(case) or EXTRA[case]
    q, caches, pos = _case_inputs(codec, c)
    h = q.shape[2]
    scale = 1.0 / np.sqrt(q.shape[-1])
    kw, sinks = _case_kw(c, h)
    tq, tp = torch.from_numpy(q), torch.from_numpy(pos)
    tc = [torch.from_numpy(a) for a in caches]
    ts = None if sinks is None else torch.from_numpy(sinks)
    got = emulate_decode(tq, tc, tp, scale, sinks=ts, codec=codec, round_p=True, **kw)
    if codec == "bf16":
        k, v = tc
    else:
        k, v = tkc.dequantize(*tc[:2]), tkc.dequantize(*tc[2:])
    plain = tfa.attention_ref(tq, k, v, tp, scale, sinks=ts, **kw)
    bound = tfa.attention_ref(tq, k, v.abs(), tp, scale, sinks=ts, **kw) * 2.0 ** -8
    err = (got - plain).abs()
    assert torch.all(err <= bound * (1 + 1e-3) + 1e-5), float((err - bound).max())
    assert float(err.max()) > 0.0                      # the rounding is there to bound
    assert torch.all(got[tp < 0] == 0.0)


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


def kernel_s8(words: np.ndarray) -> np.ndarray:
    """``codes4<kQ8>`` of csrc/attention_sm90.cuh on uint32 words: each byte,
    biased by 128 (w ^ 0x80808080), becomes the low byte of the f32 bits
    0x4B0000xx (2^23 + 128 + q), 2^23 + 128 comes off, and the f32 is
    rounded to bf16 (nearest even): 4 codes per word, byte order."""
    x = words ^ np.uint32(0x80808080)
    out = []
    for sel in range(4):
        f = (np.uint32(0x4B000000) | ((x >> np.uint32(8 * sel)) & np.uint32(0xFF))).view(
            np.float32) - np.float32(8388736.0)
        bf = torch.from_numpy(f).to(torch.bfloat16).to(torch.float32).numpy()
        assert np.array_equal(bf, f)                  # exact in f32 and in bf16
        out.append(bf)
    return np.stack(out, axis=-1)


def test_int8_bit_trick_every_byte():
    bytes_ = np.arange(256, dtype=np.uint8)
    words = bytes_.astype(np.uint32) * np.uint32(0x01010101)     # the byte in all 4 bytes
    want = bytes_.view(np.int8).astype(np.float32)
    assert np.array_equal(kernel_s8(words), np.repeat(want[:, None], 4, axis=1))
    # four different bytes of a word land in byte order, as the q8 rows'
    # consecutive d
    rng = np.random.default_rng(1)
    quads = rng.integers(-128, 128, (64, 4), dtype=np.int8)
    assert np.array_equal(kernel_s8(quads.view(np.uint32).reshape(64)), quads.astype(np.float32))
    # and as the plain version's dequantize with unit scales
    codes = torch.from_numpy(quads.reshape(1, 1, 64, 4))
    ones = torch.ones((1, 1, 1, 64))
    assert np.array_equal(tkc.dequantize(codes, ones).numpy().reshape(64, 4),
                          kernel_s8(quads.view(np.uint32).reshape(64)))
