"""KV cache: preallocated device tensors plus host-side lane bookkeeping.

Port of the bf16 part of ``rrs_tpu/runtime/kv_cache.py``: per-layer
[B, Hkv, S, D] caches (kv-head-major), one sequence per batch lane, and the
lane operations the engine uses: ``seq_new`` with LRU eviction of retained
prompt caches, ``mark_retained`` / ``unmark_retained``, ``has_seq``,
``seq_rm``, ``seq_cp``, ``seq_keep``, ``lengths_array`` and the context shift
``seq_shift``. The forward writes new rows into these tensors in place, and
``seq_cp`` / ``seq_shift`` update them in place too.

Quantized KV, ring (sliding-window) caches, MLA rows, ``seq_div`` position
remaps and M-RoPE deltas wait for their slices: ``seq_shift`` raises for the
architectures that would need them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from rrs_tpu_torch.models.config import ModelConfig


@dataclasses.dataclass
class KVCache:
    """Per-layer K/V device tensors plus host-side lane state."""

    k: list                       # L x [B, Hkv, S, D]
    v: list
    max_seq: int
    lengths: list                 # tokens currently stored per lane
    seq_ids: list                 # sequence occupying each lane (None = free)
    # seq_id -> retention time: lanes kept as prompt caches, evicted least
    # recently retained first when a new sequence needs a lane
    retained: dict = dataclasses.field(default_factory=dict)

    @property
    def n_lanes(self) -> int:
        return self.k[0].shape[0]

    @classmethod
    def create(cls, cfg: ModelConfig, n_lanes: int, max_seq: int,
               dtype=torch.bfloat16, device="cpu") -> "KVCache":
        shape = (n_lanes, cfg.n_kv_heads, max_seq, cfg.head_dim)
        k = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.n_layers)]
        v = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.n_layers)]
        return cls(k=k, v=v, max_seq=max_seq, lengths=[0] * n_lanes,
                   seq_ids=[None] * n_lanes)

    def find_free_lane(self) -> Optional[int]:
        for i, s in enumerate(self.seq_ids):
            if s is None:
                return i
        return None

    def lane_of(self, seq_id: int) -> int:
        return self.seq_ids.index(seq_id)

    def seq_new(self, seq_id: int) -> int:
        lane = self.find_free_lane()
        if lane is None and self.retained:
            # evict the least recently retained prompt cache
            self.seq_rm(min(self.retained, key=self.retained.get))
            lane = self.find_free_lane()
        if lane is None:
            raise RuntimeError("KV cache: no free lane")
        self.seq_ids[lane] = seq_id
        self.lengths[lane] = 0
        return lane

    def mark_retained(self, seq_id: int) -> None:
        if seq_id in self.seq_ids:
            self.retained[seq_id] = time.monotonic()

    def unmark_retained(self, seq_id: int) -> None:
        self.retained.pop(seq_id, None)

    def has_seq(self, seq_id: int) -> bool:
        return seq_id in self.seq_ids

    def seq_rm(self, seq_id: int, p0: int = 0) -> None:
        """Remove positions >= p0 of a sequence (p0 = 0 frees the lane)."""
        lane = self.lane_of(seq_id)
        if p0 == 0:
            self.seq_ids[lane] = None
            self.lengths[lane] = 0
            self.retained.pop(seq_id, None)
        else:
            self.lengths[lane] = min(self.lengths[lane], p0)

    def seq_cp(self, src_seq: int, dst_seq: int) -> None:
        """Fork a sequence into a fresh lane (whole-lane copy, in place)."""
        src = self.lane_of(src_seq)
        dst = self.seq_new(dst_seq)
        for c in self.k + self.v:
            c[dst].copy_(c[src])
        self.lengths[dst] = self.lengths[src]

    def seq_keep(self, seq_id: int) -> None:
        for s in list(self.seq_ids):
            if s is not None and s != seq_id:
                self.seq_rm(s)

    def lengths_array(self) -> torch.Tensor:
        return torch.tensor(self.lengths, dtype=torch.int32)

    def seq_shift(self, cfg: ModelConfig, seq_id: int, n_keep: int, n_discard: int) -> None:
        """Context shift: drop cells [n_keep, n_keep + n_discard), slide the
        tail down, and re-rotate the moved K by -n_discard positions (RoPE is
        additive in position, so one delta rotation corrects them). As in the
        JAX package, the whole lane is rolled and rotated in f32 and the first
        n_keep cells are kept as they were; the lane's tensors are updated in
        place."""
        from rrs_tpu_torch.models.llama import rope_params
        from rrs_tpu_torch.ops.basic import apply_rope

        lane = self.lane_of(seq_id)
        n = self.lengths[lane]
        n_discard = min(n_discard, n - n_keep)
        if n_discard <= 0:
            return
        rp = rope_params(cfg)
        dev = self.k[0].device
        delta = torch.full((1, 1), -n_discard, dtype=torch.int32, device=dev)
        keep = torch.arange(self.max_seq, device=dev)[None, :, None] < n_keep   # [1, S, 1]
        for k, v in zip(self.k, self.v):
            lk, lv = k[lane], v[lane]                                   # [H, S, D]
            tail = torch.roll(lk, -n_discard, dims=1)
            rk = apply_rope(tail.transpose(0, 1)[None], delta, rp)[0].transpose(0, 1)
            k[lane] = torch.where(keep, lk, rk).to(k.dtype)
            v[lane] = torch.where(keep, lv, torch.roll(lv, -n_discard, dims=1))
        self.lengths[lane] = n - n_discard
