"""Recurrent-state memory and context for the Mamba and RWKV6 families, and
``make_context``, the memory switch every entry point builds its context
through.

Port of ``rrs_tpu/runtime/recurrent.py``. Device state per layer per lane:
Mamba's conv state [d_conv - 1, d_inner] (cache dtype) and ssm state
[d_inner, d_state] (f32); RWKV6's token shifts [2, E] (cache dtype) in
``conv`` and its wkv state [H, D, D] (f32) in ``ssm``. The host state is
``KVCache``'s lane bookkeeping (one sequence a lane, retained prompt caches
evicted least recently retained first). A recurrent state cannot be rewound:
``seq_rm`` removes a whole sequence, or nothing when p0 is past its end, and
raises RuntimeError for 0 < p0 < length; ``seq_shift`` always raises.

The context runs every lane in each step (inactive lanes keep their states
through the forward's ``active`` mask), in exact-size prefill chunks: 128
tokens, then the powers of two of the remainder, since a padded token would
advance the state. It has no ``prefill_multi`` and no device decode run, so
the serving engine prefills one slot at a time and decodes step by step, as
in the JAX package. The KV quantization argument is accepted and ignored, as
there. The context's device is ``cuda`` unless ``device="cpu"`` is given,
and it raises without a GPU.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.runtime.context import ContextBase

PREFILL_CHUNK = 128


class RecurrentCache:
    """Lane-based recurrent state store with ``KVCache``'s host API."""

    kind = "recurrent"

    def __init__(self, cfg: ModelConfig, n_lanes: int, max_seq: int, dtype=torch.bfloat16,
                 device="cpu"):
        self.cfg = cfg
        self.max_seq = max_seq
        if cfg.rwkv_head_size > 0:
            h = cfg.n_embd // cfg.rwkv_head_size
            shape_c = (n_lanes, 2, cfg.n_embd)
            shape_s = (n_lanes, h, cfg.rwkv_head_size, cfg.rwkv_head_size)
        else:
            shape_c = (n_lanes, cfg.ssm_d_conv - 1, cfg.ssm_d_inner)
            shape_s = (n_lanes, cfg.ssm_d_inner, cfg.ssm_d_state)
        self.conv = [torch.zeros(shape_c, dtype=dtype, device=device)
                     for _ in range(cfg.n_layers)]
        self.ssm = [torch.zeros(shape_s, dtype=torch.float32, device=device)
                    for _ in range(cfg.n_layers)]
        self.lengths = [0] * n_lanes
        self.seq_ids: list[Optional[int]] = [None] * n_lanes
        self.retained: dict = {}
        self.sizes = [max_seq] * cfg.n_layers

    @property
    def n_lanes(self) -> int:
        return len(self.lengths)

    @property
    def quantized(self) -> bool:
        return False

    def tensors(self) -> list:
        """Every device tensor of the memory."""
        return [t for t in self.conv + self.ssm if t is not None]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())

    def find_free_lane(self) -> Optional[int]:
        for i, s in enumerate(self.seq_ids):
            if s is None:
                return i
        return None

    def lane_of(self, seq_id: int) -> int:
        return self.seq_ids.index(seq_id)

    def has_seq(self, seq_id: int) -> bool:
        return seq_id in self.seq_ids

    def mark_retained(self, seq_id: int) -> None:
        if seq_id in self.seq_ids:
            self.retained[seq_id] = time.monotonic()

    def unmark_retained(self, seq_id: int) -> None:
        self.retained.pop(seq_id, None)

    def _lane_states(self) -> list:
        """The state tensors a new lane zeroes and ``seq_cp`` copies."""
        return [t for t in self.conv + self.ssm if t is not None]

    @torch.inference_mode()
    def seq_new(self, seq_id: int) -> int:
        """A free lane (evicting the least recently retained prompt cache if
        none is free) with its recurrent states zeroed."""
        lane = self.find_free_lane()
        if lane is None and self.retained:
            self.seq_rm(min(self.retained, key=self.retained.get))
            lane = self.find_free_lane()
        if lane is None:
            raise RuntimeError(f"{self.kind} cache: no free lane")
        self.seq_ids[lane] = seq_id
        self.lengths[lane] = 0
        for t in self._lane_states():
            t[lane].zero_()
        return lane

    def seq_rm(self, seq_id: int, p0: int = 0) -> None:
        lane = self.lane_of(seq_id)
        if p0 == 0:
            self.seq_ids[lane] = None
            self.lengths[lane] = 0
            self.retained.pop(seq_id, None)
        elif p0 < self.lengths[lane]:
            # llama_memory_recurrent::seq_rm's restriction
            raise RuntimeError(f"{self.kind} memory cannot remove a sequence suffix "
                               "(a recurrent state cannot rewind)")

    @torch.inference_mode()
    def seq_cp(self, src_seq: int, dst_seq: int) -> None:
        src = self.lane_of(src_seq)
        dst = self.seq_new(dst_seq)
        for t in self._lane_states():
            t[dst].copy_(t[src])
        self.lengths[dst] = self.lengths[src]

    def seq_keep(self, seq_id: int) -> None:
        for s in list(self.seq_ids):
            if s is not None and s != seq_id:
                self.seq_rm(s)

    def seq_shift(self, cfg, seq_id, n_keep, n_discard):
        raise RuntimeError(f"context shift is not supported for {self.kind} models")


class RecurrentContext(ContextBase):
    """The context of a recurrent model: ``prefill`` / ``decode`` /
    ``generate`` / ``embed`` / ``new_sequence`` / ``kv`` / ``perf``, as the
    engine and the CLI use ``InferenceContext``'s."""

    def __init__(self, cfg: ModelConfig, weights, n_lanes: int = 1, max_seq: int = 4096,
                 kv_dtype=torch.bfloat16, kv_quant: str = "none", device=None):
        super().__init__(cfg, weights, device)
        self.kv = self._cache(n_lanes, max_seq, kv_dtype)

    def _cache(self, n_lanes: int, max_seq: int, dtype):
        return RecurrentCache(self.cfg, n_lanes, max_seq, dtype, device=self.weights.device)

    def _run(self, tok: np.ndarray, start: np.ndarray) -> torch.Tensor:
        """One step over every lane: tok [B, T] and start [B] host ints
        (start -1 = lane not in this step, its states kept). Returns logits
        [B, T, V] f32 and updates the states."""
        from rrs_tpu_torch.models import mamba, rwkv6

        model = rwkv6 if self.cfg.rwkv_head_size > 0 else mamba
        logits, self.kv.conv, self.kv.ssm = model.forward(
            self.cfg, self.weights, torch.from_numpy(tok).to(self.device), self.kv.conv,
            self.kv.ssm, active=torch.from_numpy(start >= 0).to(self.device))
        return logits

    @torch.inference_mode()
    def prefill(self, seq_id: int, tokens: list[int], all_logits: bool = True) -> torch.Tensor:
        """Feed the prompt in exact-size chunks (PREFILL_CHUNK, then powers of
        two); returns logits [T, V] f32 on the context's device (or [1, V]
        with all_logits=False)."""
        lane = self.kv.lane_of(seq_id)
        b = self.kv.n_lanes
        out = []
        i = 0
        while i < len(tokens):
            rem = len(tokens) - i
            step = PREFILL_CHUNK if rem >= PREFILL_CHUNK else 1 << (rem.bit_length() - 1)
            tok = np.zeros((b, step), np.int64)
            start = np.full((b,), -1, np.int64)
            tok[lane] = tokens[i:i + step]
            start[lane] = self.kv.lengths[lane]
            t0 = time.perf_counter()
            logits = self._run(tok, start)
            out.append(logits[lane] if all_logits else logits[lane, -1:])
            self._sync()
            self.t_prefill_s += time.perf_counter() - t0
            self.kv.lengths[lane] += step
            self.n_prefill_tokens += step
            i += step
        return torch.cat(out, dim=0) if all_logits else out[-1]

    @torch.inference_mode()
    def decode(self, seq_tokens: dict[int, int]) -> dict[int, torch.Tensor]:
        """One step for the given sequences: {seq_id: token} -> {seq_id:
        logits [V]}."""
        b = self.kv.n_lanes
        tok = np.zeros((b, 1), np.int64)
        start = np.full((b,), -1, np.int64)
        lanes = {}
        for seq_id, token in seq_tokens.items():
            lane = self.kv.lane_of(seq_id)
            tok[lane, 0] = token
            start[lane] = self.kv.lengths[lane]
            lanes[seq_id] = lane
        t0 = time.perf_counter()
        logits = self._run(tok, start)
        out = {}
        for seq_id, lane in lanes.items():
            out[seq_id] = logits[lane, 0]
            self.kv.lengths[lane] += 1
            self.n_decode_tokens += 1
        self._sync()
        self.t_decode_s += time.perf_counter() - t0
        return out

    def _pooled_state(self, lane: int) -> torch.Tensor:
        """The JAX package's embedding: the last layer's ssm state of the
        lane, averaged over its last axis."""
        return self.kv.ssm[-1][lane].mean(dim=-1).reshape(-1)

    def embed(self, tokens: list[int], pooling: str = "mean") -> np.ndarray:
        """Prefill a throwaway sequence and pool its recurrent state (the JAX
        package's recurrent embedding; ``pooling`` is ignored, as there).
        Returns f32 on the host."""
        seq = self.new_sequence()
        try:
            self.prefill(seq, tokens)
            v = self._pooled_state(self.kv.lane_of(seq))
        finally:
            self.kv.seq_rm(seq)
        return v.to(torch.float32).cpu().numpy()


def make_context(cfg: ModelConfig, weights, **kw):
    """The context for ``cfg``'s memory: hybrid (jamba), recurrent (Mamba,
    RWKV6) or attention (``InferenceContext``), as llama_model::create_memory
    picks it. ``kw``: the contexts' own arguments (n_lanes, max_seq,
    kv_dtype, kv_quant, device, and ``mesh``, which the recurrent and hybrid
    contexts refuse, as rrs_tpu/runtime/recurrent.py:251-254 does)."""
    if cfg.is_hybrid or cfg.is_recurrent:
        if kw.get("mesh") is not None:
            raise NotImplementedError(
                "--tp/--dp is not yet supported for recurrent/hybrid models")
        kw.pop("mesh", None)
    if cfg.is_hybrid:
        from rrs_tpu_torch.runtime.hybrid import HybridContext

        return HybridContext(cfg, weights, **kw)
    if cfg.is_recurrent:
        return RecurrentContext(cfg, weights, **kw)
    from rrs_tpu_torch.runtime.context import InferenceContext

    return InferenceContext(cfg, weights, **kw)
