"""Inference context: the prefill / decode loop and the serving decode runs.

Port of ``rrs_tpu/runtime/context.py`` (``PREFILL_BUCKETS``, ``_step``,
``_run``, ``new_sequence``, ``prefill``, ``prefill_logprobs``,
``prefill_multi``, ``decode``, the device-side ``decode_run_start`` /
``decode_run`` with their penalty operands and eviction schedule,
``generate``, ``perf``, the mesh). PyTorch runs eagerly, so the
bucketed chunk lengths no longer pick a compiled program; they are kept so
that every matmul sees the M the JAX package gives it and routes to the same
kernel.

The JAX decode run is one jitted ``lax.scan`` of N forward + sample steps.
Here it is a Python loop of N steps with the same rules: tokens, counts,
mirostat mu and the DRY ring stay on the device; positions and cache slots
come from the known host lengths (start + i), uploaded once per run, so the
loop reads nothing back; the run is read back once, when the caller reads
the handle; a chained run starts from the previous handle's device outputs.
A run may carry a grammar's token DFA (``dfa=``): each step masks the
lane's illegal tokens and steps the lane's DFA state on the device.
``embed`` pools the final hidden states of a standalone forward.
``prefill_embeds`` feeds raw [T, E] embeddings (image chunks) in place of the
token embedding, with Qwen2-VL's [T, 3] M-RoPE rows when given the chunk's
merged grid. Whenever a lane's RoPE positions leave its slots (``seq_div``'s
``slot_pos`` or an M-RoPE delta), every step feeds absolute positions per
row (``_pos_rows``); the mask and the cache slots stay slot-derived.

With a ``mesh`` (``parallel/sharding.py``; --tp / --dp) the weights split
over the shards (heads and FFN over tp) and the cache over their rows (lanes
over dp, kv heads over tp; ``ShardedKVCache``); every step runs the forward
on all shards at once (``ShardedModel.forward``), and the rows' gathered
logits come back stacked on the lane axis, so the sampler and everything
after it run as they do on one device. ``ContextBase`` holds what this
context shares with the recurrent and hybrid ones (the device check,
sequence ids, perf counters, the host penalty window, ``generate``).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from rrs_tpu_torch.device import resolve_device, set_matmul_precision
from rrs_tpu_torch.models import llama as llama_model
from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.ops.basic import rms_norm
from rrs_tpu_torch.runtime import sampler as smp
from rrs_tpu_torch.runtime.kv_cache import KVCache, ShardedKVCache
from rrs_tpu_torch.runtime.sampler import SamplerParams, sample

PREFILL_BUCKETS = (16, 64, 256, 512, 1024, 2048)


def step_inputs(tokens: np.ndarray, start_pos: np.ndarray, s: int):
    """The host arrays of one step, as the JAX step builds them: positions
    start + i, mask positions (-1 for a lane not in the step), tokens with
    padding at 0, and each lane's first slot (-1 for a lane not in it)."""
    b, t = tokens.shape
    pos = start_pos[:, None].astype(np.int32) + np.arange(t, dtype=np.int32)[None, :]
    mask_pos = np.where(start_pos[:, None] < 0, -1, pos).astype(np.int32)
    safe_tokens = np.maximum(tokens, 0).astype(np.int64)
    slots = [int(min(max(p, 0), s - 1)) if st >= 0 else -1
             for p, st in zip(pos[:, 0], start_pos)]
    return safe_tokens, pos, mask_pos, slots


def _bucket(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    return PREFILL_BUCKETS[-1]


class ContextBase:
    """What every context shares (this one, and the recurrent and hybrid
    ones of ``runtime/recurrent.py`` / ``runtime/hybrid.py``): the device
    check, sequence ids, the perf counters, the host penalty window and
    ``generate``. A subclass sets ``self.kv``."""

    def __init__(self, cfg: ModelConfig, weights, device=None):
        """``device``: where the step runs; ``None`` means ``cuda``, which
        raises when there is no GPU. The weights must already live there."""
        self.device = resolve_device(device)
        if weights.device.type != self.device.type:
            raise ValueError(f"weights are on {weights.device}, context on {self.device}")
        set_matmul_precision()
        self.cfg = cfg
        self.weights = weights
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

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A small host array on the context's device without waiting for
        the device: pinned memory and an asynchronous copy on the card."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def new_sequence(self) -> int:
        seq_id = self._next_seq_id
        self._next_seq_id += 1
        self.kv.seq_new(seq_id)
        return seq_id

    @staticmethod
    def _penalties_active(p) -> bool:
        # penalty_last_n == 0 disables penalties outright
        return (p.penalty_last_n != 0
                and (p.penalty_repeat != 1.0 or p.penalty_freq != 0.0
                     or p.penalty_present != 0.0))

    @staticmethod
    def _pen_window(hist, last_n: int):
        """penalty_last_n sentinels: 0 is an empty window, < 0 the whole
        history."""
        if last_n == 0:
            return []
        if last_n < 0:
            return hist
        return hist[-last_n:]

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


class InferenceContext(ContextBase):
    """Single-model inference context over a fixed-lane KV cache."""

    def __init__(self, cfg: ModelConfig, weights: llama_model.ModelWeights,
                 n_lanes: int = 1, max_seq: int = 2048, kv_dtype=torch.bfloat16,
                 kv_quant: str = "none", device=None, mesh=None):
        """``device``: as ``ContextBase`` takes it (with a mesh, default its
        first shard's). ``kv_quant``: "none" (``kv_dtype`` caches), "q8" or
        "q4". ``mesh``: a ``parallel.sharding.Mesh`` to shard the model and
        the cache over (unfused weights; n_lanes a multiple of dp); the
        context then holds only the shards' weights."""
        if mesh is not None and device is None:
            device = next(d for d in mesh.devices if d is not None)
        super().__init__(cfg, weights, device)
        # a ring must cover the largest chunk: models with sliding layers
        # cap it at 512 so that their rings stay window + 512 slots
        self.max_chunk = min(512 if cfg.any_swa else PREFILL_BUCKETS[-1], max_seq)
        self.mesh = mesh
        self.sharded = None
        if mesh is None:
            self.kv = KVCache.create(cfg, n_lanes, max_seq, kv_dtype, device=weights.device,
                                     quant=kv_quant, max_chunk=self.max_chunk)
            return
        from rrs_tpu_torch.parallel.sharding import ShardedModel

        if n_lanes % mesh.dp:
            raise ValueError(f"n_lanes={n_lanes} must be divisible by dp={mesh.dp}")
        self.sharded = ShardedModel(cfg, weights, mesh)
        self.weights = None
        self.kv = ShardedKVCache.create_sharded(cfg, n_lanes, max_seq, mesh, kv_dtype,
                                                quant=kv_quant, max_chunk=self.max_chunk)

    def _forward(self, tokens, positions, mask_positions, slots: list, last_idx=None,
                 embeds=None) -> torch.Tensor:
        """``llama.forward`` over this context's cache, on one device or on
        the mesh's shards; ``slots``: each lane's first cache slot (-1 for a
        lane not in the step)."""
        if self.sharded is not None:
            return self.sharded.forward(self.kv.parts, tokens, positions, mask_positions,
                                        last_idx=last_idx, slots=slots, embeds=embeds)
        return llama_model.forward(self.cfg, self.weights, tokens, positions, self.kv.k,
                                   self.kv.v, mask_positions, None, last_idx=last_idx,
                                   slots=slots, embeds=embeds)

    def _step(self, tokens: np.ndarray, start_pos: np.ndarray, last_only: bool = False,
              last_idx: Optional[np.ndarray] = None, pos_row: Optional[np.ndarray] = None,
              embeds=None) -> torch.Tensor:
        """tokens [B, T] (-1 = padding); start_pos [B] (-1 = lane not in this
        step). Builds the causal positions and cache slots on the host and
        runs the forward; padded lanes attend nothing and write nothing to
        their cache. ``last_only`` / ``last_idx`` [B]: only
        the final / the given position of each lane reaches the lm_head.
        ``pos_row`` ([B, T] or M-RoPE [B, T, 3] ints): the RoPE positions, when
        they leave the slots; ``embeds`` [B, T, E]: raw input embeddings in
        place of the tokens'."""
        b, t = tokens.shape
        toks, pos, mask_pos, slots = step_inputs(tokens, start_pos, self.kv.max_seq)
        if last_only and last_idx is None:
            last_idx = np.full((b,), t - 1, np.int64)
        return self._forward(torch.from_numpy(toks),
                             torch.from_numpy(pos if pos_row is None else pos_row),
                             torch.from_numpy(mask_pos), slots, last_idx=last_idx,
                             embeds=embeds)

    def _pos_rows(self, start_pos_np: np.ndarray, t: int) -> Optional[np.ndarray]:
        """[B, t] absolute RoPE positions when some lane's positions leave
        its slots (a ``seq_div`` remap or an M-RoPE delta); None otherwise."""
        if not (self.kv.slot_pos or self.kv.mrope_delta):
            return None
        rows = np.zeros((len(start_pos_np), t), np.int32)
        for lane, st in enumerate(start_pos_np):
            if int(st) >= 0:
                rows[lane] = self.kv.positions_row(lane, int(st), t)
        return rows

    def _run(self, tokens_np: np.ndarray, start_pos_np: np.ndarray, last_only: bool = False,
             last_idx: Optional[np.ndarray] = None) -> torch.Tensor:
        return self._step(tokens_np, start_pos_np, last_only=last_only, last_idx=last_idx,
                          pos_row=self._pos_rows(start_pos_np, tokens_np.shape[1]))

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
    def prefill_logprobs(self, seq_id: int, tokens: list[int],
                         targets: list[int]) -> np.ndarray:
        """Prefill the tokens and return log p(targets[i] | tokens[..i]) as
        float64 [T], with the log-softmax and the gather on the device (the
        readback is [T] floats, not [T, V] logits)."""
        if len(targets) != len(tokens):
            raise ValueError(f"{len(targets)} targets for {len(tokens)} tokens")
        lane = self.kv.lane_of(seq_id)
        b = self.kv.n_lanes
        out = []
        i = 0
        while i < len(tokens):
            chunk = tokens[i: i + self.max_chunk]
            t = min(_bucket(len(chunk)), self.max_chunk)
            tok = np.full((b, t), -1, np.int32)
            tgt = np.zeros((b, t), np.int64)
            start = np.full((b,), -1, np.int32)
            tok[lane, : len(chunk)] = chunk
            tgt[lane, : len(chunk)] = targets[i: i + len(chunk)]
            start[lane] = self.kv.lengths[lane]
            t0 = time.perf_counter()
            logits = self._run(tok, start)
            tg = torch.from_numpy(tgt).to(logits.device)
            lp = torch.gather(logits, -1, tg[:, :, None])[:, :, 0] - torch.logsumexp(logits, -1)
            out.append(lp[lane, : len(chunk)].to(torch.float64).cpu().numpy())
            self.t_prefill_s += time.perf_counter() - t0
            self.kv.lengths[lane] += len(chunk)
            self.n_prefill_tokens += len(chunk)
            i += len(chunk)
        return np.concatenate(out, axis=0)

    @torch.inference_mode()
    def prefill_multi(self, chunks: dict[int, list[int]]) -> dict[int, torch.Tensor]:
        """Several sequences' prompt chunks in one bucketed step, each lane's
        final position gathered before the lm_head. Each chunk must fit
        max_chunk. Returns the final-position logits [V] per sequence."""
        if not chunks:
            raise ValueError("prefill_multi: no chunks")
        b = self.kv.n_lanes
        t = min(_bucket(max(len(c) for c in chunks.values())), self.max_chunk)
        tok = np.full((b, t), -1, np.int32)
        start = np.full((b,), -1, np.int32)
        last = np.zeros((b,), np.int64)
        lanes = {}
        for seq_id, c in chunks.items():
            if not 0 < len(c) <= t:
                raise ValueError(f"prefill_multi: chunk of {len(c)} tokens for a {t} step")
            lane = self.kv.lane_of(seq_id)
            lanes[seq_id] = lane
            tok[lane, : len(c)] = c
            start[lane] = self.kv.lengths[lane]
            last[lane] = len(c) - 1
        t0 = time.perf_counter()
        logits = self._run(tok, start, last_idx=last)
        out = {}
        for seq_id, c in chunks.items():
            self.kv.lengths[lanes[seq_id]] += len(c)
            self.n_prefill_tokens += len(c)
            out[seq_id] = logits[lanes[seq_id], 0]
        self._sync()
        self.t_prefill_s += time.perf_counter() - t0
        return out

    @torch.inference_mode()
    def prefill_embeds(self, seq_id: int, embeds, mrope_grid=None) -> torch.Tensor:
        """Feed raw input embeddings [T, E] (an image chunk) in one step of
        exactly T rows, in bf16; returns logits [T, V] f32 on the context's
        device. ``mrope_grid`` ((gh, gw), the merged grid of a Qwen2-VL image):
        the chunk takes the (t, h, w) M-RoPE rows of ``mrope_begin_image``,
        which leaves the lane's later text positions trailing its slots."""
        lane = self.kv.lane_of(seq_id)
        b = self.kv.n_lanes
        embeds = torch.as_tensor(embeds)
        t = embeds.shape[0]
        emb = torch.zeros((b, t, embeds.shape[1]), dtype=torch.bfloat16, device=self.device)
        emb[lane] = embeds.to(self.device, torch.bfloat16)
        start = np.full((b,), -1, np.int32)
        start[lane] = self.kv.lengths[lane]
        if mrope_grid is not None:
            gh, gw = mrope_grid
            if gh * gw != t:
                raise ValueError(f"M-RoPE grid {mrope_grid} for a chunk of {t} rows")
            pos_row = np.zeros((b, t, 3), np.int32)
            pos_row[lane] = self.kv.mrope_begin_image(lane, gh, gw)
        else:
            pos_row = self._pos_rows(start, t)
        t0 = time.perf_counter()
        logits = self._step(np.zeros((b, t), np.int32), start, pos_row=pos_row,
                            embeds=emb)[lane]
        self._sync()
        self.t_prefill_s += time.perf_counter() - t0
        self.kv.lengths[lane] += t
        self.n_prefill_tokens += t
        return logits

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

    # -- device-side multi-token decode (the serving fast path) ------------

    # tokens per run; the engine rewinds the overshoot past a stop. 24 keeps
    # slots with the default penalty_last_n = 64 on the fast path (chained
    # runs need last_n >= 2n, see the engine's _fast_eligible)
    DECODE_RUN_STEPS = int(os.environ.get("RRS_DECODE_RUN_STEPS", "24"))

    @torch.inference_mode()
    def decode_run_start(self, seq_tokens: dict, keys: dict, params: dict, n_steps: int = 0,
                         chain: Optional[dict] = None, histories: Optional[dict] = None,
                         mus: Optional[dict] = None, dfa: Optional[tuple] = None) -> dict:
        """Enqueue (without waiting) an n_steps decode + sample run. Feeds each
        sequence's pending token and samples n_steps tokens per lane on the
        device; lane lengths advance by n_steps (the final sampled token is
        not fed), and callers rewind with seq_rm when they accept fewer.

        ``keys``: one ``torch.Generator`` per sequence, on this context's
        device; its state advances with the run's draws. ``chain``: a
        previous run's handle, whose device outputs (last tokens, counts, mu,
        DRY ring) and operands this run starts from. ``histories``: each
        sequence's generated tokens, for the penalty counts of a fresh run
        and the per-step eviction schedule that slides the penalty window
        (callers keep penalty_last_n >= 2 * n_steps for chained runs).
        ``mus``: mirostat-v2 mu per sequence. ``dfa``: (masks [S, V] bool,
        trans [S, V] int16, {seq_id: state row}) of a grammar's token DFA on
        this device; each step sets a live lane's illegal logits to NEG_INF
        (after XTC and top-n-sigma, before the candidates) and moves its
        state through ``trans`` (a -1 entry ends the lane's masking); the run
        leaves the states in the handle's ``gstate`` for a chained run.
        Returns the handle; its tensors stay on the device until the caller
        reads them."""
        n = n_steps or self.DECODE_RUN_STEPS
        b, dev = self.kv.n_lanes, self.device
        if chain is not None:
            feats = chain["feats"]
            lanes = dict(chain["lanes"])
            start = [st + chain["n"] if st >= 0 else st for st in chain["start"]]
            tok = chain["toks"][:, -1]
            gens = chain["gens"]
            ops = chain["ops"]
            counts, mu, dwin = chain["counts"], chain["mu"], chain["dwin"]
            gmask, gtrans, gstate = chain["gmask"], chain["gtrans"], chain["gstate"]
            evict = self._evict_schedule(histories, lanes, chain.get("params", {}), n,
                                         offset=chain["n"])
        else:
            feats = (any(p.xtc_probability > 0 for p in params.values()),
                     any(p.mirostat for p in params.values()),
                     any(p.typical_p < 1.0 for p in params.values()),
                     any(p.top_n_sigma > 0 for p in params.values()),
                     any(p.dry_multiplier > 0 for p in params.values()),
                     dfa is not None)
            lanes, start, tok, gens, ops, mu, dwin = self._run_operands(
                seq_tokens, keys, params, histories, mus)
            gmask = gtrans = None
            gstate = np.full((b,), -1, np.int64)
            if dfa is not None:
                gmask, gtrans, rows = dfa
                for seq_id, row in rows.items():
                    gstate[lanes[seq_id]] = row
            gstate = self._upload(gstate)
            rep, frq, prs, counts, bias = self._penalty_operands(lanes, params, histories)
            ops.update(rep=rep, frq=frq, prs=prs, bias=bias)
            evict = self._evict_schedule(histories, lanes, params, n, offset=0)
        xtc, mir, typ, sig, dry, gdfa = feats
        pos = np.array([[st + i if st >= 0 else -1 for st in start] for i in range(n)],
                       np.int32)                                           # [n, B]
        pos_dev = self._upload(pos)
        live = self._upload(np.asarray(start, np.int32) >= 0)
        ones = torch.ones((b, 1), dtype=torch.float32, device=dev)

        t0 = time.perf_counter()
        out, cvs, cis = [], [], []
        for i in range(n):
            pcol = pos_dev[i][:, None]
            logits = self._forward(tok[:, None], pcol, pcol, [int(p) for p in pos[i]])
            lg = smp.device_penalties(logits[:, 0, :].to(torch.float32), counts, ops["rep"],
                                      ops["frq"], ops["prs"], ops["bias"])
            if xtc:
                lg = smp.device_xtc(lg, gens, ops["temp"], ops["xtc_p"], ops["xtc_t"])
            if sig:
                lg = smp.device_top_n_sigma(lg, ops["nsig"])
            if gdfa:
                glive = gstate >= 0
                srow = gstate.clamp(0, gmask.shape[0] - 1)
                rowm = gmask.index_select(0, srow)[:, : lg.shape[-1]]           # [B, V]
                lg = torch.where(glive[:, None] & ~rowm, smp.NEG_INF, lg)
            cv, ci = smp.topk_candidates(lg)
            if dry:
                cv, ci = smp.device_dry(dwin, cv, ci, ops["dry_mult"], ops["dry_base"],
                                        ops["dry_allowed"], ops["dry_lastn"])
            nxt = smp.device_sample(lg, gens, ops["temp"], ops["top_k"], ops["top_p"],
                                    ops["min_p"], cands=(cv, ci),
                                    typ_p=ops["typ_p"] if typ else None)
            if mir:
                mtok, mu2 = smp.device_mirostat(lg, gens, ops["temp"], mu, ops["eta"],
                                                ops["tau"])
                mir_on = ops["eta"] > 0
                nxt = torch.where(mir_on, mtok, nxt)
                mu = torch.where(mir_on & live, mu2, mu)
            nxt = torch.where(live, nxt, tok)
            # slide the penalty window: the sampled token in, the
            # host-scheduled evictee (-1 = none) out
            ev = evict[:, i]
            counts = counts.scatter_add(1, nxt[:, None], ones).scatter_add(
                1, ev.clamp_min(0)[:, None], -(ev >= 0).to(torch.float32)[:, None])
            if dry:
                dwin = torch.cat([dwin[:, 1:], nxt[:, None]], dim=1)
            if gdfa:
                ns = gtrans.reshape(-1).index_select(0, srow * gtrans.shape[1] + nxt)
                gstate = torch.where(glive & live, ns.to(gstate.dtype), gstate)
            out.append(nxt)
            cvs.append(cv)
            cis.append(ci)
            tok = nxt
        for lane in lanes.values():
            self.kv.lengths[lane] += n
            self.n_decode_tokens += n
        self.t_decode_s += time.perf_counter() - t0
        return {"toks": torch.stack(out, dim=1), "cand_v": torch.stack(cvs, dim=1),
                "cand_i": torch.stack(cis, dim=1), "gens": gens, "lanes": lanes, "n": n,
                "start": start, "ops": ops, "counts": counts, "mu": mu, "dwin": dwin,
                "gmask": gmask, "gtrans": gtrans, "gstate": gstate,
                "feats": feats, "params": dict(params)}

    def _run_operands(self, seq_tokens, keys, params, histories, mus):
        """Per-lane sampling operands of a fresh run, uploaded once."""
        b = self.kv.n_lanes
        f32 = lambda fill: np.full((b,), fill, np.float32)      # noqa: E731
        ops_np = dict(temp=f32(0.0), top_p=f32(1.0), min_p=f32(0.0), xtc_p=f32(0.0),
                      xtc_t=f32(1.0), eta=f32(0.0), tau=f32(0.0), typ_p=f32(1.0),
                      nsig=f32(0.0), dry_mult=f32(0.0), dry_base=f32(1.0),
                      top_k=np.ones((b,), np.int64), dry_allowed=np.ones((b,), np.int64),
                      dry_lastn=np.zeros((b,), np.int64))
        mu = f32(0.0)
        dwin = np.full((b, smp.DRY_WINDOW), -1, np.int64)
        tok = np.zeros((b,), np.int64)
        start = [-1] * b
        gens: list = [None] * b
        lanes = {}
        for seq_id, token in seq_tokens.items():
            lane = self.kv.lane_of(seq_id)
            lanes[seq_id] = lane
            start[lane] = self.kv.lengths[lane]
            p = params[seq_id]
            ops_np["temp"][lane] = p.temperature
            ops_np["top_k"][lane] = min(p.top_k, 128) if p.top_k > 0 else 128
            ops_np["top_p"][lane] = p.top_p
            ops_np["min_p"][lane] = p.min_p
            if p.xtc_probability > 0:
                ops_np["xtc_p"][lane] = p.xtc_probability
                ops_np["xtc_t"][lane] = p.xtc_threshold
            if p.mirostat:
                ops_np["eta"][lane] = p.mirostat_eta
                ops_np["tau"][lane] = p.mirostat_tau
                mu[lane] = (mus or {}).get(seq_id) or 2.0 * p.mirostat_tau
            ops_np["typ_p"][lane] = p.typical_p
            ops_np["nsig"][lane] = p.top_n_sigma
            if p.dry_multiplier > 0:
                ops_np["dry_mult"][lane] = p.dry_multiplier
                ops_np["dry_base"][lane] = p.dry_base
                ops_np["dry_allowed"][lane] = max(1, p.dry_allowed_length)
                ops_np["dry_lastn"][lane] = smp.DRY_WINDOW if p.penalty_last_n < 0 \
                    else min(p.penalty_last_n, smp.DRY_WINDOW)
                recent = ((histories or {}).get(seq_id) or [])[-smp.DRY_WINDOW:]
                if recent:
                    dwin[lane, -len(recent):] = recent
            tok[lane] = token
            gens[lane] = keys[seq_id]
        ops = {k: self._upload(v) for k, v in ops_np.items()}
        return (lanes, start, self._upload(tok), gens, ops, self._upload(mu),
                self._upload(dwin))

    def _penalty_operands(self, lanes, params, histories):
        """[B] rep / frq / prs and [B, V] counts / bias of a fresh run. The
        all-identity case reuses cached device tensors (the run never writes
        into its operands), so penalty-free serving uploads nothing."""
        b, v = self.kv.n_lanes, self.cfg.vocab_size
        if not any(self._penalties_active(p) or p.logit_bias for p in params.values()):
            if not hasattr(self, "_pen_identity"):
                dev = self.device
                self._pen_identity = (
                    torch.ones((b,), dtype=torch.float32, device=dev),
                    torch.zeros((b,), dtype=torch.float32, device=dev),
                    torch.zeros((b,), dtype=torch.float32, device=dev),
                    torch.zeros((b, v), dtype=torch.float32, device=dev),
                    torch.zeros((b, v), dtype=torch.float32, device=dev))
            return self._pen_identity
        rep = np.ones((b,), np.float32)
        frq = np.zeros((b,), np.float32)
        prs = np.zeros((b,), np.float32)
        counts = np.zeros((b, v), np.float32)
        bias = np.zeros((b, v), np.float32)
        for seq_id, p in params.items():
            lane = lanes[seq_id]
            if self._penalties_active(p):
                rep[lane] = p.penalty_repeat
                frq[lane] = p.penalty_freq
                prs[lane] = p.penalty_present
                for t in self._pen_window((histories or {}).get(seq_id, []), p.penalty_last_n):
                    if 0 <= t < v:
                        counts[lane, t] += 1
            for tid, bval in p.logit_bias:
                if 0 <= int(tid) < v:
                    bias[lane, int(tid)] += float(bval)
        return tuple(self._upload(a) for a in (rep, frq, prs, counts, bias))

    def _evict_schedule(self, histories, lanes, params, n_steps, offset) -> torch.Tensor:
        """[B, n_steps] token ids leaving the penalty window after each
        sampled step (-1 = none). ``offset``: device-sampled tokens the host
        history does not hold yet (a chained run: the previous run's n)."""
        ev = np.full((self.kv.n_lanes, n_steps), -1, np.int64)
        for seq_id, hist in (histories or {}).items():
            p = (params or {}).get(seq_id)
            if p is None or not self._penalties_active(p) or p.penalty_last_n < 0:
                continue                        # a whole-history window never evicts
            true_len = len(hist) + offset
            for i in range(n_steps):
                e = true_len + i - p.penalty_last_n
                if 0 <= e < len(hist):
                    ev[lanes[seq_id], i] = hist[e]
        return self._upload(ev)

    def decode_run(self, seq_tokens: dict, keys: dict, params: dict, n_steps: int = 0):
        """Synchronous decode_run_start: ({seq: [n] tokens}, {seq: generator})."""
        h = self.decode_run_start(seq_tokens, keys, params, n_steps)
        toks = h["toks"].cpu().numpy()
        return ({s: toks[lane] for s, lane in h["lanes"].items()},
                {s: h["gens"][lane] for s, lane in h["lanes"].items()})

    @torch.inference_mode()
    def embed(self, tokens: list[int], pooling: str = "mean") -> np.ndarray:
        """Sequence embedding from the final hidden states: one standalone
        forward over throwaway caches (``scratch_caches``; the context's own
        cache is untouched), no lm_head, the final norm, then mean or last
        pooling. Returns f32 [E] on the host. The layers are the forward's
        own (``llama.layer``), embedding scale, sandwich norms, post-norms
        and residual scale included, where the JAX package's ``hidden``
        skips them (ROADMAP queue C). On a mesh every shard runs it with its
        local config; the hidden states are whole on each."""
        if self.sharded is not None:
            hs = self.sharded.run(lambda sh: self._hidden(sh.cfg, sh.weights, tokens,
                                                          sh.device))[0]
        else:
            hs = self._hidden(self.cfg, self.weights, tokens, self.device)
        vec = hs[-1] if pooling == "last" else hs.mean(dim=0)
        return vec.cpu().numpy()

    @staticmethod
    def _hidden(cfg, w, tokens: list[int], device) -> torch.Tensor:
        """The final-normed hidden states [T, E] f32 of a standalone forward."""
        t = len(tokens)
        ks, vs = llama_model.scratch_caches(cfg, 1, t, device=device)
        pos = torch.arange(t, dtype=torch.int32, device=device)[None, :]
        x = llama_model.embed_tokens(
            cfg, w, torch.as_tensor(np.asarray(tokens, np.int64), device=device)[None, :])
        for li, lw in enumerate(w.layers):
            x = llama_model.layer(cfg, w, lw, x, pos, ks[li], vs[li], pos, [0], li)
        return rms_norm(x, w.final_norm, cfg.rms_eps)[0].to(torch.float32)
