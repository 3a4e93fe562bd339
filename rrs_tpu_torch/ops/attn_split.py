"""The split-S plan of the attention kernels B3 (``flash_attention``, bf16
rows), B6 (``flash_attention_q8``), B7 (``flash_attention_q4hp``) and B8
(``flash_attention_q4``), and their scratch.

The kernels (one template, ``csrc/attention_sm90.cuh``) have two bodies.
The decode body takes a code plane (HEADS_PER_PLANE kv heads of the codec)
whose rows (the T * G query rows of each kv head) number at most
DECODE_ROWS; it covers the cache with a grid of (lane, code plane) x
``n_split`` blocks, split ``n_split`` owning ``split_tiles`` whole TILE-slot
tiles of [0, S). The plan gives the grid at least MIN_BLOCKS blocks (two
waves on the H100's 132 SMs) wherever S has that many tiles and a plane's
splits times its rows stay within MAX_PARTIALS; with fewer tiles, every tile
is a split of its own. The plan reads shapes only, never positions, so a
launch's shape does not depend on device data: a split past its lane's live
length is clipped on the card and writes an empty partial. With more than
one split each block writes its rows' f32 partials (running max,
denominator and D sums) to ``scratch``, and the plane's last block to
finish merges them in split order, so the result does not depend on which
block ends first. The counters (one int32 per (lane, plane)) are
``splitk``'s: zero before a launch and left zero by it, so one buffer per
device serves every call on its stream. Planes with more rows take the
prefill body, one block per (lane, kv head, 64 query rows), unsplit; its
K/V tile is the kernel's own choice per codec and changes no shape here.
"""

from __future__ import annotations

import dataclasses

import torch

from rrs_tpu_torch.ops import splitk

TILE = 64                   # cache slots per tile of the decode body
MIN_BLOCKS = 264            # two waves on 132 SMs
DECODE_ROWS = 16            # query rows of one kv head (T * G) in one mma tile
MAX_PARTIALS = 2048         # (split, row) pairs a plane's combine stages in shared memory
# kv heads per code plane of each cache codec: a head-pair byte holds two
HEADS_PER_PLANE = {"bf16": 1, "q8": 1, "q4hp": 2, "q4": 1}


@dataclasses.dataclass(frozen=True)
class Plan:
    decode: bool                # the split-S body (else the prefill body)
    n_split: int
    split_tiles: int            # TILE-slot tiles per split (the last may be shorter)
    scratch_elems: int          # f32 elements of the partials (0: one split)
    counters: int               # int32 counters the launch uses (0: one split)


def plan(codec: str, b: int, hkv: int, t: int, g: int, s: int, d: int) -> Plan:
    """The grid of the attention kernel for a ``codec`` cache (a key of
    HEADS_PER_PLANE) over ``b`` lanes of ``hkv`` kv heads of ``g`` query
    heads each, for ``t`` queries per lane over an S-slot cache of head dim
    ``d``."""
    heads = HEADS_PER_PLANE[codec]
    planes = hkv // heads
    tiles = -(-s // TILE)
    if t * g > DECODE_ROWS:
        return Plan(False, 1, tiles, 0, 0)
    rows = heads * t * g
    need = -(-MIN_BLOCKS // (b * planes))
    per = tiles if need <= 1 else max(1, tiles // need, -(-tiles // (MAX_PARTIALS // rows)))
    n_split = -(-tiles // per)
    if n_split == 1:
        return Plan(True, 1, tiles, 0, 0)
    return Plan(True, n_split, per, b * planes * n_split * rows * (d + 2), b * planes)


def buffers(p: Plan, device: torch.device):
    """(scratch, counters) for a launch under plan ``p``: the partials, fresh
    from the caching allocator, and the device's counters (``splitk``'s,
    kept zero by the kernels). Both None with one split."""
    if p.n_split == 1:
        return None, None
    scratch = torch.empty((p.scratch_elems,), dtype=torch.float32, device=device)
    return scratch, splitk.counters(device, p.counters)
