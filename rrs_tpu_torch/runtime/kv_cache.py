"""KV cache: preallocated device tensors plus host-side lane bookkeeping.

Port of the bf16 part of ``rrs_tpu/runtime/kv_cache.py``: per-layer
[B, Hkv, S, D] caches (kv-head-major), one sequence per batch lane, and the
lane operations ``generate`` uses. The forward writes new rows into these
tensors in place. Quantized KV, ring (sliding-window) caches, prompt-cache
retention, copy, shift and div wait for their slices.
"""

from __future__ import annotations

import dataclasses
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
        if lane is None:
            raise RuntimeError("KV cache: no free lane")
        self.seq_ids[lane] = seq_id
        self.lengths[lane] = 0
        return lane

    def seq_rm(self, seq_id: int, p0: int = 0) -> None:
        """Remove positions >= p0 of a sequence (p0 = 0 frees the lane)."""
        lane = self.lane_of(seq_id)
        if p0 == 0:
            self.seq_ids[lane] = None
            self.lengths[lane] = 0
        else:
            self.lengths[lane] = min(self.lengths[lane], p0)

