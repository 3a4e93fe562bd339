"""Byte-level codec between GGUF `block_tcq4_tile` payloads and TCQ4Tensor.

Copied from ``rrs_tpu/formats/tile_codec.py`` (decoder and encoder), so the
port reads reference-produced TCQ4_K32 GGUF files and its ``quantize`` verb
writes them.
The on-disk tile is 1184 bytes covering 8 output channels x 256 K
(ggml/src/ggml-common.h:308-348):

    uint8  tiles[8][128]   int4 pairs in IMMA m16n8k32 B-fragment order
    fp16   S[8]            per-channel super-scales
    fp16   Z[8]            per-channel super-zeros
    int8   sc[8][8]        per-channel per-group scale codes
    int8   zc[8][8]        per-channel per-group zero codes

IMMA fragment order (tcq4_pack_imma_tile, ggml-quants.c:1380-1400): within
group g, CUDA lane L owns channel L//4 and k-slice L%4; its uint32 at bytes
[4L, 4L+4) packs 8 int4 values, element i in bits [4i, 4i+4). This layout
encodes warp-lane ownership and is purely an interchange format here — on
device we use the K-major layout of rrs_tpu_torch.formats.tcq4.

Tile order within a tensor of N rows x K cols: tile_idx = (row//8) * (K//256)
+ k_tile (quantize_tcq4_tile loop, ggml-quants.c:1552-1632). Requires N%8==0
(guaranteed by the quantize policy, src/llama-quant.cpp:473-496).
"""

from __future__ import annotations

import numpy as np

from rrs_tpu_torch.formats.tcq4 import TCQ4Tensor, TILE_K, pack_nibbles, unpack_nibbles

TILE_BYTES = 1184


def _tiles_to_q(tiles: np.ndarray) -> np.ndarray:
    """[T, 8g, 128B] uint8 -> int8 q [T, 8c, 256k]."""
    t = tiles.shape[0]
    b = tiles.reshape(t, 8, 32, 4)             # [T, g, lane, byte]
    lo = (b & 0xF).astype(np.int8)
    hi = (b >> 4).astype(np.int8)
    vals = np.stack([lo, hi], axis=-1).reshape(t, 8, 32, 8)   # [T,g,lane,i]
    vals = np.where(vals >= 8, vals - 16, vals)
    # lane -> (channel, k_slice); k = k_slice*8 + i
    vals = vals.reshape(t, 8, 8, 4, 8)          # [T, g, c, k_slice, i]
    vals = vals.transpose(0, 2, 1, 3, 4)        # [T, c, g, k_slice, i]
    return vals.reshape(t, 8, 256)


def _q_to_tiles(q: np.ndarray) -> np.ndarray:
    """int8 q [T, 8c, 256k] -> [T, 8g, 128B] uint8."""
    t = q.shape[0]
    v = q.reshape(t, 8, 8, 4, 8)                # [T, c, g, k_slice, i]
    v = v.transpose(0, 2, 1, 3, 4)              # [T, g, c, k_slice, i]
    v = v.reshape(t, 8, 32, 8)                  # [T, g, lane, i]
    u = (v.astype(np.int16) & 0xF).astype(np.uint8)
    packed = u[..., 0::2] | (u[..., 1::2] << 4)  # [T, g, lane, 4]
    return packed.reshape(t, 8, 128)


def decode_tcq4_gguf(raw: np.ndarray, shape: tuple[int, ...]) -> TCQ4Tensor:
    """Parse a TCQ4_K32 GGUF payload for a logical [N, K] weight."""
    n, k = shape[-2], shape[-1]
    if n % 8 or k % TILE_K:
        raise ValueError(f"TCQ4_K32 tensor shape {shape}: needs N % 8 == 0 and K % 256 == 0")
    kt = k // TILE_K
    tiles = raw.reshape(n // 8, kt, TILE_BYTES)   # [rg, kt, 1184]

    frag = tiles[:, :, :1024].reshape(-1, 8, 128)
    q = _tiles_to_q(frag).reshape(n // 8, kt, 8, 256)       # [rg, kt, c, k]
    S = tiles[:, :, 1024:1040].copy().view(np.float16).reshape(n // 8, kt, 8)
    Z = tiles[:, :, 1040:1056].copy().view(np.float16).reshape(n // 8, kt, 8)
    sc = tiles[:, :, 1056:1120].view(np.int8).reshape(n // 8, kt, 8, 8)  # [.., c, g]
    zc = tiles[:, :, 1120:1184].view(np.int8).reshape(n // 8, kt, 8, 8)

    # -> K-major [K, N]
    q_kn = q.transpose(1, 3, 0, 2).reshape(k, n)            # [kt*256, rg*8]
    sc_kn = sc.transpose(1, 3, 0, 2).reshape(kt * 8, n)     # [K//32, N]
    S_kn = S.transpose(1, 0, 2).reshape(kt, n)
    zc_kn = zc.transpose(1, 3, 0, 2).reshape(kt * 8, n)
    Z_kn = Z.transpose(1, 0, 2).reshape(kt, n)

    symmetric = not zc_kn.any() and not np.asarray(Z_kn, np.float32).any()
    return TCQ4Tensor(
        qs=pack_nibbles(q_kn.astype(np.int8)),
        sc=np.ascontiguousarray(sc_kn),
        S=np.ascontiguousarray(S_kn),
        zc=None if symmetric else np.ascontiguousarray(zc_kn),
        Z=None if symmetric else np.ascontiguousarray(Z_kn),
    )


def encode_tcq4_gguf(t: TCQ4Tensor) -> bytes:
    """Serialize a TCQ4Tensor to reference block_tcq4_tile bytes."""
    k, n = t.K, t.N
    if n % 8 or k % TILE_K:
        raise ValueError(f"TCQ4_K32 tensor [{n}, {k}]: needs N % 8 == 0 and K % 256 == 0")
    kt = k // TILE_K
    q = unpack_nibbles(t.qs)                                  # [K, N]
    q_t = q.reshape(kt, 256, n // 8, 8).transpose(2, 0, 1, 3)  # [rg, kt, k, c]
    q_t = q_t.transpose(0, 1, 3, 2).reshape(-1, 8, 256)        # [T, c, k]
    frag = _q_to_tiles(q_t).reshape(n // 8, kt, 1024)

    sc = t.sc.reshape(kt, 8, n // 8, 8).transpose(2, 0, 3, 1)  # [rg, kt, c, g]
    S = t.S.astype(np.float16).reshape(kt, n // 8, 8).transpose(1, 0, 2)
    if t.zc is not None:
        zc = t.zc.reshape(kt, 8, n // 8, 8).transpose(2, 0, 3, 1)
        Z = t.Z.astype(np.float16).reshape(kt, n // 8, 8).transpose(1, 0, 2)
    else:
        zc = np.zeros_like(sc)
        Z = np.zeros_like(S)

    out = np.empty((n // 8, kt, TILE_BYTES), np.uint8)
    out[:, :, :1024] = frag
    out[:, :, 1024:1040] = S.copy().view(np.uint8).reshape(n // 8, kt, 16)
    out[:, :, 1040:1056] = Z.copy().view(np.uint8).reshape(n // 8, kt, 16)
    out[:, :, 1056:1120] = sc.view(np.uint8).reshape(n // 8, kt, 64)
    out[:, :, 1120:1184] = zc.view(np.uint8).reshape(n // 8, kt, 64)
    return out.tobytes()
