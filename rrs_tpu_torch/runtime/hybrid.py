"""Hybrid memory and context (jamba).

Port of ``rrs_tpu/runtime/hybrid.py``: attention layers get bf16 K/V lanes
[B, Hkv, max_seq, D], Mamba layers conv / ssm state lanes, under one lane
bookkeeping with the recurrent memory's restrictions (no mid-sequence
rewind, no context shift). The context is ``RecurrentContext``'s, exact
chunks included; its step also builds the attention layers' positions, mask
and cache slots (a lane not in the step has mask -1 and writes no K/V rows,
as in ``InferenceContext``).
"""

from __future__ import annotations

import numpy as np
import torch

from rrs_tpu_torch.models import hybrid as hybrid_model
from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.runtime.recurrent import RecurrentCache, RecurrentContext


class HybridCache(RecurrentCache):
    """Per layer: (k, v) for an attention layer, (conv, ssm) for a Mamba
    layer; None for the other pair."""

    kind = "hybrid"

    def __init__(self, cfg: ModelConfig, kinds: list, n_lanes: int, max_seq: int,
                 dtype=torch.bfloat16, device="cpu"):
        self.cfg = cfg
        self.kinds = kinds
        self.max_seq = max_seq
        self.k, self.v, self.conv, self.ssm = [], [], [], []
        for kind in kinds:
            attn = kind == "attn"

            def zeros(shape, dt=dtype, on=True):
                return torch.zeros(shape, dtype=dt, device=device) if on else None

            kv_shape = (n_lanes, cfg.n_kv_heads, max_seq, cfg.head_dim)
            self.k.append(zeros(kv_shape, on=attn))
            self.v.append(zeros(kv_shape, on=attn))
            self.conv.append(zeros((n_lanes, cfg.ssm_d_conv - 1, cfg.ssm_d_inner), on=not attn))
            self.ssm.append(zeros((n_lanes, cfg.ssm_d_inner, cfg.ssm_d_state), torch.float32,
                                  on=not attn))
        self.lengths = [0] * n_lanes
        self.seq_ids = [None] * n_lanes
        self.retained = {}
        self.sizes = [max_seq] * cfg.n_layers

    def tensors(self) -> list:
        return [t for t in self.k + self.v + self.conv + self.ssm if t is not None]

    def _lane_states(self) -> list:
        return [t for t in self.conv + self.ssm if t is not None]

    @torch.inference_mode()
    def seq_cp(self, src_seq: int, dst_seq: int) -> None:
        super().seq_cp(src_seq, dst_seq)
        src, dst = self.lane_of(src_seq), self.lane_of(dst_seq)
        for t in self.k + self.v:
            if t is not None:
                t[dst].copy_(t[src])


class HybridContext(RecurrentContext):
    """The context of a jamba model (``RecurrentContext``'s surface)."""

    def _cache(self, n_lanes: int, max_seq: int, dtype):
        return HybridCache(self.cfg, [hl.kind for hl in self.weights.layers], n_lanes, max_seq,
                           dtype, device=self.weights.device)

    def _run(self, tok: np.ndarray, start: np.ndarray) -> torch.Tensor:
        t = tok.shape[1]
        pos = (start[:, None] + np.arange(t)[None, :]).astype(np.int32)
        mask = np.where(start[:, None] < 0, -1, pos).astype(np.int32)
        dev = self.device
        logits, self.kv.conv, self.kv.ssm = hybrid_model.forward(
            self.cfg, self.weights, torch.from_numpy(tok).to(dev),
            torch.from_numpy(np.maximum(pos, 0)).to(dev), self.kv.k, self.kv.v, self.kv.conv,
            self.kv.ssm, torch.from_numpy(mask).to(dev), [int(s) for s in start])
        return logits

    def _pooled_state(self, lane: int) -> torch.Tensor:
        """The first Mamba layer's ssm state, averaged over its last axis (E
        zeros without one), as the JAX package pools it."""
        for kind, s in zip(self.kv.kinds, self.kv.ssm):
            if kind != "attn":
                return s[lane].mean(dim=-1)
        return torch.zeros((self.cfg.n_embd,), device=self.device)
