"""Inference context: the prefill / decode loop.

Port of the single-device part of ``rrs_tpu/runtime/context.py``
(``PREFILL_BUCKETS``, ``_step``, ``_run``, ``new_sequence``, ``prefill``,
``decode``, ``generate``, ``perf``). PyTorch runs eagerly, so the bucketed
chunk lengths no longer pick a compiled program; they are kept so that every
matmul sees the M the JAX package gives it and routes to the same kernel.
The mesh, the device-side ``decode_run`` and the serving paths wait for
their slices.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from rrs_tpu_torch.device import resolve_device, set_matmul_precision
from rrs_tpu_torch.models import llama as llama_model
from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.runtime.kv_cache import KVCache
from rrs_tpu_torch.runtime.sampler import SamplerParams, sample

PREFILL_BUCKETS = (16, 64, 256, 512, 1024, 2048)


def _bucket(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    return PREFILL_BUCKETS[-1]


class InferenceContext:
    """Single-model inference context over a fixed-lane KV cache."""

    def __init__(self, cfg: ModelConfig, weights: llama_model.ModelWeights,
                 n_lanes: int = 1, max_seq: int = 2048, kv_dtype=torch.bfloat16,
                 device=None):
        """``device``: where the step runs; ``None`` means ``cuda``, which
        raises when there is no GPU. The weights must already live there."""
        self.device = resolve_device(device)
        if weights.device.type != self.device.type:
            raise ValueError(f"weights are on {weights.device}, context on {self.device}")
        set_matmul_precision()
        self.cfg = cfg
        self.weights = weights
        self.max_chunk = min(PREFILL_BUCKETS[-1], max_seq)
        self.kv = KVCache.create(cfg, n_lanes, max_seq, kv_dtype, device=weights.device)
        self._next_seq_id = 0
        # perf counters (llama_perf_context analog)
        self.n_prefill_tokens = 0
        self.n_decode_tokens = 0
        self.t_prefill_s = 0.0
        self.t_decode_s = 0.0

    def perf(self) -> dict:
        """Token counts and throughput of the prefill and decode calls so far."""
        return {
            "n_p_eval": self.n_prefill_tokens,
            "n_eval": self.n_decode_tokens,
            "t_p_eval_ms": self.t_prefill_s * 1e3,
            "t_eval_ms": self.t_decode_s * 1e3,
            "pp_tok_per_s": self.n_prefill_tokens / self.t_prefill_s
            if self.t_prefill_s else 0.0,
            "tg_tok_per_s": self.n_decode_tokens / self.t_decode_s
            if self.t_decode_s else 0.0,
        }

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _step(cfg, weights, kv: KVCache, tokens: np.ndarray, start_pos: np.ndarray,
              last_only: bool = False) -> torch.Tensor:
        """tokens [B, T] (-1 = padding); start_pos [B] (-1 = lane not in this
        step). Builds the causal positions and cache slots on the host and
        runs the forward; padded lanes attend nothing and park their cache
        writes at the top of the cache."""
        b, t = tokens.shape
        s = kv.max_seq
        pos = start_pos[:, None].astype(np.int32) + np.arange(t, dtype=np.int32)[None, :]
        mask_pos = np.where(start_pos[:, None] < 0, -1, pos).astype(np.int32)
        safe_tokens = np.maximum(tokens, 0).astype(np.int64)
        safe_slots = np.where(start_pos[:, None] < 0, s - 1, np.clip(pos, 0, s - 1))
        last_idx = np.full((b,), t - 1, np.int64) if last_only else None
        return llama_model.forward(
            cfg, weights, torch.from_numpy(safe_tokens), torch.from_numpy(pos),
            kv.k, kv.v, torch.from_numpy(mask_pos), torch.from_numpy(safe_slots),
            last_idx=last_idx)

    def _run(self, tokens_np: np.ndarray, start_pos_np: np.ndarray,
             last_only: bool = False) -> torch.Tensor:
        return self._step(self.cfg, self.weights, self.kv, tokens_np, start_pos_np,
                          last_only=last_only)

    def new_sequence(self) -> int:
        seq_id = self._next_seq_id
        self._next_seq_id += 1
        self.kv.seq_new(seq_id)
        return seq_id

    @torch.inference_mode()
    def prefill(self, seq_id: int, tokens: list[int], all_logits: bool = True) -> torch.Tensor:
        """Feed prompt tokens in bucketed chunks; returns logits [T, V] f32 on
        the context's device (or only the final position [1, V] with
        all_logits=False)."""
        lane = self.kv.lane_of(seq_id)
        b = self.kv.n_lanes
        out = []
        i = 0
        while i < len(tokens):
            chunk = tokens[i: i + self.max_chunk]
            t = min(_bucket(len(chunk)), self.max_chunk)
            tok = np.full((b, t), -1, np.int32)
            start = np.full((b,), -1, np.int32)
            tok[lane, : len(chunk)] = chunk
            start[lane] = self.kv.lengths[lane]
            t0 = time.perf_counter()
            last = not all_logits and len(chunk) == t
            logits = self._run(tok, start, last_only=last)
            if all_logits:
                out.append(logits[lane, : len(chunk)])
            elif last:
                out = [logits[lane]]
            else:
                out = [logits[lane, len(chunk) - 1: len(chunk)]]
            self._sync()
            self.t_prefill_s += time.perf_counter() - t0
            self.kv.lengths[lane] += len(chunk)
            self.n_prefill_tokens += len(chunk)
            i += len(chunk)
        return torch.cat(out, dim=0)

    @torch.inference_mode()
    def decode(self, seq_tokens: dict[int, int]) -> dict[int, torch.Tensor]:
        """One batched decode step: {seq_id: token} -> {seq_id: logits [V]}."""
        b = self.kv.n_lanes
        tok = np.full((b, 1), -1, np.int32)
        start = np.full((b,), -1, np.int32)
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

    def generate(self, prompt: list[int], max_new_tokens: int,
                 params: Optional[SamplerParams] = None,
                 stop_tokens: tuple[int, ...] = ()) -> list[int]:
        """Single-sequence generation: prefill, then one host sample and one
        decode step per token. The draws come from a CPU ``torch.Generator``
        seeded with ``params.seed``."""
        params = params or SamplerParams(temperature=0.0)
        gen = torch.Generator().manual_seed(params.seed)
        seq = self.new_sequence()
        try:
            last = self.prefill(seq, prompt)[-1:]
            out = []
            for _ in range(max_new_tokens):
                token = int(sample(last, gen, params)[0])
                if token in stop_tokens:
                    break
                out.append(token)
                last = self.decode({seq: token})[seq][None, :]
        finally:
            self.kv.seq_rm(seq)
        return out
