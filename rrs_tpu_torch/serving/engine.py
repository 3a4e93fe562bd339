"""Continuous-batching inference engine (server-context.cpp analog).

Port of ``rrs_tpu/serving/engine.py`` (``Engine``, ``Slot``, ``GenRequest``,
``SlotState``, the token-DFA compile cache). Slot lifecycle: IDLE -> PROMPT
(chunked prefill, several slots' chunks in one step) -> GENERATING (one shared decode for every
generating slot) -> released on a stop token or string, max_tokens or
cancellation; a released lane keeps its KV as a prompt cache for the next
request with a shared prefix, except on a model with sliding layers, whose
rings no longer hold the prefix's window (the lane is freed). Decoding goes
through the context's device-side runs of DECODE_RUN_STEPS tokens, chained
so that run N+1 is enqueued before run N is read; slots the runs cannot
serve take the per-token host sampler. A lane that reaches max_seq - 1 is
context-shifted; on a model with sliding layers, which cannot shift, the
slot finishes by length instead. A recurrent or hybrid context
(``runtime/recurrent.py``, ``runtime/hybrid.py``) cannot rewind, as in the
JAX package: its prompt cache is reused only on a full-prefix match (any
other restarts the sequence), it prefills one slot a step, decodes step by
step with no draft, and finishes by length at the limit. Slot state (a
slot's sequence, saved to or
restored from a state file, or erased) is handled on the engine thread,
between iterations, through ``call``.

Grammar slots ride the device runs: with the grammar's token DFA compiled
(in a spawned process, ``_dfa_compile_async``), the run masks illegal tokens
on the device and stays chained; without it, the run samples freely and the
host PDA validates each token at flush, a violation resampled from the run's
captured candidates. Infill slots take the host chain's infill sampler. With
a draft context, a lone greedy slot decodes speculatively (the draft
proposes, the target verifies in one chunked step). A multimodal request
carries ordered ``segments`` (token runs and image embedding chunks, a
Qwen2-VL chunk with its merged grid): it prefills one segment a step, skips
the prompt cache on both ends, and decodes step by step once its lane's
positions leave its slots (an M-RoPE delta or a ``seq_div`` remap).
"""

from __future__ import annotations

import dataclasses
import enum
import os
import queue
import threading
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch

from rrs_tpu_torch.runtime.context import InferenceContext
from rrs_tpu_torch.runtime.sampler import (SamplerParams, dry_penalties, infill_sample,
                                           mirostat_v2_sample, sample)

# Token DFAs of grammars whose PDA state space closes within the state budget
# (runtime/grammar.py TokenDFA), compiled once and then enforced inside the
# device decode run. The compile runs in a spawned process
# (runtime/dfa_worker.py, which imports no torch): seconds of pure-Python
# trie walking on a sibling thread would hold the GIL against the engine
# thread. Keyed by (gbnf, vocab size); None records a failed or oversized
# compile, which is not retried.
_DFA_CACHE: dict = {}
_DFA_PENDING: set = set()
_DFA_LOCK = threading.Lock()
# seconds of the last compile of each key, for the measuring scripts
DFA_COMPILE_S: dict = {}


def _dfa_compile_async(key, grammar, pieces, eog_ids) -> None:
    """Compile the grammar's token DFA in a spawned process on a
    background thread; the result lands in ``_DFA_CACHE[key]``."""
    gbnf = getattr(grammar, "gbnf", "")
    if not gbnf:
        return                      # the child rebuilds the grammar from its text
    with _DFA_LOCK:
        if key in _DFA_CACHE or key in _DFA_PENDING:
            return
        _DFA_PENDING.add(key)

    def work():
        import multiprocessing as mp
        import pickle
        import tempfile

        from rrs_tpu_torch.runtime.dfa_worker import dfa_worker

        dfa, path = None, None
        t0 = time.perf_counter()
        try:
            fd, path = tempfile.mkstemp(prefix="rrs_dfa_", suffix=".pkl")
            os.close(fd)
            proc = mp.get_context("spawn").Process(
                target=dfa_worker, args=(gbnf, list(pieces), tuple(eog_ids), path),
                daemon=True)
            proc.start()
            proc.join(timeout=600)
            if proc.is_alive():
                proc.terminate()
            else:
                with open(path, "rb") as f:
                    dfa = pickle.load(f)
        except Exception:                                     # noqa: BLE001
            dfa = None
        finally:
            if path is not None:
                try:
                    os.unlink(path)
                except OSError:
                    pass
        with _DFA_LOCK:
            _DFA_CACHE[key] = dfa
            DFA_COMPILE_S[key] = time.perf_counter() - t0
            _DFA_PENDING.discard(key)

    threading.Thread(target=work, daemon=True).start()


class SlotState(enum.Enum):
    IDLE = 0
    PROMPT = 1
    GENERATING = 2


@dataclasses.dataclass
class GenRequest:
    prompt_tokens: list[int]
    max_tokens: int = 128
    params: SamplerParams = dataclasses.field(default_factory=SamplerParams)
    stop_tokens: tuple[int, ...] = ()
    stop_strings: tuple[str, ...] = ()
    # callback(token_id, text_piece, finished, finish_reason)
    on_token: Optional[Callable] = None
    decode_fn: Optional[Callable[[list[int]], str]] = None  # ids -> text
    grammar: Optional[object] = None          # runtime.grammar.Grammar
    token_pieces: Optional[list[str]] = None  # vocab pieces for grammar masking
    token_trie: Optional[dict] = None         # prefix trie over the pieces
    n_probs: int = 0                          # top-k logprobs per token
    # callback(token_id, logprob, [(tid, logprob) x n_probs])
    on_probs: Optional[Callable] = None
    # multimodal: ordered prompt segments ("tokens", [ids]) | ("embeds", [T, E])
    # | ("embeds_mrope", ([T, E], (gh, gw))); when set, prompt_tokens is not fed
    segments: Optional[list] = None
    infill: bool = False                      # fill-in-the-middle: the infill sampler
    # set by the submitter (e.g. on client disconnect) to stop generating
    abort: bool = False
    id: int = 0


@dataclasses.dataclass
class Slot:
    index: int
    state: SlotState = SlotState.IDLE
    req: Optional[GenRequest] = None
    seq_id: int = -1
    prompt_pos: int = 0
    generated: list = dataclasses.field(default_factory=list)
    sent_text_len: int = 0
    last_logits: Optional[torch.Tensor] = None     # [V] on the context's device
    key: Optional[torch.Generator] = None          # per request, on the device
    t_start: float = 0.0
    n_prompt: int = 0
    grammar: Optional[object] = None               # the request's grammar, advanced
    mirostat_mu: float = 10.0
    draft_seq: int = -1                            # the draft model's sequence
    # prompt-cache retention: the lane's KV survives release so the next
    # request with a shared prefix skips re-prefilling it
    retained_seq: int = -1
    cache_tokens: list = dataclasses.field(default_factory=list)
    n_reused: int = 0
    # set by _emit when it returns True: "stop", "length" or "cancelled"
    finish_reason: str = "stop"


def _segment_rows(seg) -> int:
    """Cache rows a prompt segment fills."""
    kind, payload = seg
    if kind == "embeds":
        return payload.shape[0]
    if kind == "embeds_mrope":
        return payload[0].shape[0]
    return len(payload)


class Engine:
    """Background thread turning queued requests into streamed tokens."""

    # per-iteration prompt budget (n_batch analog); long prompts land in the
    # 1024 / 2048 prefill buckets
    PROMPT_CHUNK = 1024

    def __init__(self, ctx: InferenceContext, draft_ctx: Optional[InferenceContext] = None,
                 n_draft: int = 4):
        """The engine serves on the context's device (every context chooses
        ``cuda`` unless asked for the CPU, and raises without a GPU).
        ``draft_ctx``: a draft model's context for server-side speculative
        decoding, engaged in a decode round where exactly one slot generates
        greedily with no grammar, penalties or logprobs; it proposes
        ``n_draft`` tokens, which the target verifies in one chunked step."""
        self.draft_ctx = draft_ctx
        self.n_draft = n_draft
        self.n_drafted = 0
        self.n_draft_accepted = 0
        self.ctx = ctx
        self.slots = [Slot(i) for i in range(ctx.kv.n_lanes)]
        self.pending: "queue.Queue[GenRequest]" = queue.Queue()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._next_id = 0
        self._lock = threading.Lock()
        # work run on the engine thread between iterations (slot state I/O),
        # so that it never races a step over the same cache
        self._side: "queue.Queue" = queue.Queue()
        # the enqueued, not yet read, device decode run
        self._inflight = None
        # metrics (/metrics)
        self.n_prompt_tokens = 0
        self.n_generated_tokens = 0
        self.n_requests = 0
        self.n_decode_runs = 0
        self.n_dfa_runs = 0                 # device runs that carried a token DFA
        self.n_resampled = 0                # grammar violations resampled at flush

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5)

    def submit(self, req: GenRequest) -> int:
        with self._lock:
            self._next_id += 1
            req.id = self._next_id
        self.pending.put(req)
        self._wake.set()
        return req.id

    def call(self, fn, timeout: float = 300.0):
        """Run ``fn()`` on the engine thread, between iterations, and return
        its result (or raise its error); called directly when the engine is
        not running. Slot state is read and changed only there."""
        if not self._thread.is_alive():
            return fn()
        done = threading.Event()
        box: dict = {}

        def task():
            try:
                box["r"] = fn()
            except Exception as e:                            # noqa: BLE001
                box["e"] = e
            done.set()

        self._side.put(task)
        self._wake.set()
        if not done.wait(timeout):
            raise TimeoutError("engine side task timed out")
        if "e" in box:
            raise box["e"]
        return box.get("r")

    # -- slot state (/slots/{id}?action=save|restore|erase) -----------------

    def erase_slot(self, index: int) -> None:
        """Drop a slot's retained prompt cache."""
        s = self.slots[index]
        if s.retained_seq >= 0:
            if self.ctx.kv.has_seq(s.retained_seq):
                self.ctx.kv.seq_rm(s.retained_seq)
            s.retained_seq = -1
            s.cache_tokens = []

    def save_slot(self, index: int, path: str) -> dict:
        """Write the slot's sequence (live or retained) and its tokens to a
        state file."""
        from rrs_tpu_torch.runtime import state as state_io

        s = self.slots[index]

        def do():
            seq = s.seq_id if s.seq_id >= 0 else s.retained_seq
            if seq < 0:
                raise ValueError(f"slot {index} has no sequence to save")
            n_bytes = state_io.save_sequence(self.ctx, seq, path,
                                             tokens=s.cache_tokens or None)
            return n_bytes, self.ctx.kv.lengths[self.ctx.kv.lane_of(seq)]

        n_bytes, n_saved = self.call(do)
        return {"id_slot": index, "filename": str(path), "n_saved": n_saved,
                "n_written": n_bytes}

    def restore_slot(self, index: int, path: str) -> dict:
        """Load a state file into an idle slot as its retained prompt cache."""
        from rrs_tpu_torch.runtime import state as state_io

        s = self.slots[index]

        def do():
            if s.state != SlotState.IDLE:
                raise ValueError(f"slot {index} is busy")
            self.erase_slot(index)
            seq_id, tokens = state_io.load_sequence(self.ctx, path)
            s.retained_seq = seq_id
            s.cache_tokens = list(tokens or [])
            self.ctx.kv.mark_retained(seq_id)
            return self.ctx.kv.lengths[self.ctx.kv.lane_of(seq_id)]

        return {"id_slot": index, "filename": str(path), "n_restored": self.call(do)}

    # -- slots -------------------------------------------------------------

    def _free_slot(self) -> Optional[Slot]:
        for s in self.slots:
            if s.state == SlotState.IDLE:
                return s
        return None

    def _launch(self, slot: Slot, req: GenRequest):
        kv = self.ctx.kv
        n_prompt = (len(req.prompt_tokens) if req.segments is None
                    else sum(_segment_rows(seg) for seg in req.segments))
        if n_prompt >= kv.max_seq:
            # admitting it would clip every overflow position into the last cell
            if req.on_token:
                req.on_token(None, "", True, "error: prompt too long "
                             f"({n_prompt} tokens, context {kv.max_seq})")
            return
        slot.state = SlotState.PROMPT
        slot.req = req
        slot.n_reused = 0
        if self.draft_ctx is not None:
            # the draft runs the whole prompt, so the target's prefix reuse
            # is off in speculative mode (the two caches stay in lockstep)
            self.erase_slot(slot.index)
            slot.draft_seq = self.draft_ctx.new_sequence()
        if req.segments is not None:
            # image chunks are not tokens: no prefix reuse
            self.erase_slot(slot.index)
        if slot.retained_seq >= 0 and not kv.has_seq(slot.retained_seq):
            slot.retained_seq = -1      # the prompt cache was LRU-evicted
            slot.cache_tokens = []
        if slot.retained_seq >= 0:
            # prompt-cache reuse: keep the common prefix of the retained KV;
            # at least one prompt token is fed again to produce logits, and
            # the reuse stops at what the lane stores (cache_tokens holds the
            # final sampled token, which was never fed)
            stored = kv.lengths[kv.lane_of(slot.retained_seq)]
            limit = min(len(slot.cache_tokens), stored, len(req.prompt_tokens) - 1)
            n_common = 0
            while n_common < limit and slot.cache_tokens[n_common] == req.prompt_tokens[n_common]:
                n_common += 1
            slot.seq_id = slot.retained_seq
            slot.retained_seq = -1
            kv.unmark_retained(slot.seq_id)
            if n_common > 0:
                try:
                    kv.seq_rm(slot.seq_id, p0=n_common)
                except RuntimeError:
                    # a recurrent or hybrid memory cannot rewind mid-sequence:
                    # only a full-prefix match is reused; anything else restarts
                    n_common = 0
            if n_common == 0:
                kv.seq_rm(slot.seq_id)
                slot.seq_id = self.ctx.new_sequence()
            slot.prompt_pos = n_common
            slot.n_reused = n_common
        else:
            slot.seq_id = self.ctx.new_sequence()
            slot.prompt_pos = 0
        slot.cache_tokens = []
        slot.generated = []
        slot.sent_text_len = 0
        slot.key = torch.Generator(device=self.ctx.device).manual_seed(req.params.seed + req.id)
        slot.t_start = time.time()
        slot.n_prompt = n_prompt
        slot.grammar = req.grammar.copy() if req.grammar is not None else None
        if (slot.grammar is not None and req.token_pieces and req.token_trie is not None
                and not getattr(req.grammar, "lazy", False)):
            _dfa_compile_async(self._dfa_key(req), req.grammar, req.token_pieces,
                               tuple(req.stop_tokens))
        slot.mirostat_mu = 2.0 * req.params.mirostat_tau
        slot.finish_reason = "stop"
        self.n_requests += 1

    def _release(self, slot: Slot, reason: str):
        req = slot.req
        if req and req.on_token:
            req.on_token(None, "", True, reason)
        if slot.draft_seq >= 0 and self.draft_ctx is not None:
            if self.draft_ctx.kv.has_seq(slot.draft_seq):
                self.draft_ctx.kv.seq_rm(slot.draft_seq)
            slot.draft_seq = -1
        if slot.seq_id >= 0 and (self.ctx.cfg.any_swa or (req is not None
                                                          and req.segments is not None)):
            # ring caches cannot serve a later request's prefix, nor can a
            # lane holding image rows (its cache is not its tokens): free it
            self.ctx.kv.seq_rm(slot.seq_id)
        elif slot.seq_id >= 0:
            # retain the lane's KV as a prompt cache for the next request
            slot.retained_seq = slot.seq_id
            slot.cache_tokens = (list(req.prompt_tokens) + list(slot.generated)) if req else []
            self.ctx.kv.mark_retained(slot.seq_id)
        slot.state = SlotState.IDLE
        slot.req = None
        slot.seq_id = -1
        slot.last_logits = None

    # -- emitting ------------------------------------------------------------

    @staticmethod
    def _stop_holdback(full: str, stop_strings) -> int:
        """Chars at the end of ``full`` that are a prefix of some stop string,
        withheld from streaming so that a stop string completed by a later
        token never leaks in part."""
        hold = 0
        for ss in stop_strings:
            top = min(len(ss) - 1, len(full))
            for j in range(top, hold, -1):
                if full.endswith(ss[:j]):
                    hold = j
                    break
        return hold

    def _emit(self, slot: Slot, token: int) -> bool:
        """Append a generated token, stream its text, check the stop
        conditions. True when the slot should be released; the reason lands
        in slot.finish_reason ("stop" | "length" | "cancelled")."""
        req = slot.req
        slot.generated.append(token)
        self.n_generated_tokens += 1
        if req.abort:
            slot.finish_reason = "cancelled"
            return True
        if token in req.stop_tokens:
            slot.finish_reason = "stop"
            return True
        finishing = len(slot.generated) >= req.max_tokens
        piece = ""
        if req.decode_fn:
            full = req.decode_fn(slot.generated)
            for ss in req.stop_strings:
                idx = full.find(ss)
                if idx >= 0:
                    piece = full[slot.sent_text_len: idx]
                    if piece and req.on_token:
                        req.on_token(token, piece, False, None)
                    slot.finish_reason = "stop"
                    return True
            piece = full[slot.sent_text_len:]
            if not finishing:
                # hold back text that may become a stop string or a partial
                # multi-byte character once later tokens arrive
                hold = self._stop_holdback(full, req.stop_strings)
                if hold:
                    piece = piece[: max(0, len(piece) - hold)]
                if piece.endswith("�"):
                    piece = piece[:-1]
            if piece:
                slot.sent_text_len += len(piece)
        if req.on_token:
            req.on_token(token, piece, False, None)
        if finishing:
            slot.finish_reason = "length"
        return finishing

    def _emit_probs(self, slot: Slot, token: int) -> None:
        """The sampled token's logprob and the top-n alternatives from the
        full logits (completion n_probs / OAI logprobs)."""
        req = slot.req
        if not req or req.n_probs <= 0 or req.on_probs is None or slot.last_logits is None:
            return
        raw = slot.last_logits.to(torch.float64).cpu().numpy()
        m = raw.max()
        lp = raw - (m + np.log(np.exp(raw - m).sum()))
        k = min(req.n_probs, lp.shape[-1])
        top = np.argpartition(-lp, k - 1)[:k]
        top = top[np.argsort(-lp[top])]
        req.on_probs(token, float(lp[token]), [(int(t), float(lp[t])) for t in top])

    def _emit_probs_fast(self, slot: Slot, token: int, vals, ids) -> None:
        """n_probs logprobs from a decode run's captured top-128 candidate
        row, log-softmax renormalized over the candidates (the tail past rank
        128 carries negligible mass)."""
        req = slot.req
        if not req or req.n_probs <= 0 or req.on_probs is None:
            return
        v = np.asarray(vals, np.float64)
        ids = np.asarray(ids)
        m = v.max()
        lp = v - (m + np.log(np.exp(v - m).sum()))
        k = min(req.n_probs, len(ids))
        where = np.nonzero(ids == token)[0]
        # mirostat samples the full vocab; a pick outside the candidates
        # reports the worst candidate's logprob
        tok_lp = float(lp[where[0]]) if len(where) else float(lp[-1])
        req.on_probs(token, tok_lp, [(int(ids[j]), float(lp[j])) for j in range(k)])

    def _sample_token(self, slot: Slot) -> int:
        """The host chain on the slot's last logits, drawing from its
        generator; a grammar slot's pick is checked (and, if illegal,
        resampled under the grammar's mask) by ``_grammar_check``."""
        raw = slot.last_logits
        p = slot.req.params
        if p.dry_multiplier > 0.0:
            pen = dry_penalties(slot.generated, raw.shape[-1], multiplier=p.dry_multiplier,
                                base=p.dry_base, allowed_length=p.dry_allowed_length,
                                penalty_last_n=p.penalty_last_n)
            if pen:
                raw = raw.clone()
                for tid, v in pen.items():
                    if tid < raw.shape[-1]:
                        raw[tid] -= v
        if p.mirostat:
            token, slot.mirostat_mu = mirostat_v2_sample(
                raw.to(torch.float32).cpu().numpy(), slot.key, slot.mirostat_mu, p)
            return self._grammar_check(slot, token)
        if slot.req.infill and slot.req.token_pieces:
            token = infill_sample(raw.to(torch.float32).cpu().numpy(), slot.req.token_pieces,
                                  set(slot.req.stop_tokens), slot.key)
            return self._grammar_check(slot, token)
        counts = None
        if p.penalty_repeat != 1.0 or p.penalty_freq or p.penalty_present:
            c = np.zeros((1, raw.shape[-1]), np.float32)
            for t in self.ctx._pen_window(slot.generated, p.penalty_last_n):
                c[0, t] += 1
            counts = torch.from_numpy(c)
        token = int(sample(raw[None, :], slot.key, p, recent_counts=counts)[0])
        return self._grammar_check(slot, token, counts)

    def _grammar_check(self, slot: Slot, token: int, counts=None) -> int:
        """Advance the slot's grammar with ``token`` when it is legal; else
        mask the logits with the grammar's full mask, resample, and advance
        with the new pick (the sample-first, mask-on-rejection strategy). A
        lazy grammar awaiting its trigger only watches the text."""
        g = slot.grammar
        if g is None:
            return token
        pieces = slot.req.token_pieces
        piece = pieces[token] if pieces and token < len(pieces) else ""
        if getattr(g, "awaiting_trigger", False):
            g.feed_token(token, piece)
            return token
        if token in slot.req.stop_tokens:
            if g.done:
                return token            # grammar complete: EOS allowed
        elif piece and g.accept_text(piece):
            return token
        mask = np.asarray(g.allowed_mask(pieces, trie=slot.req.token_trie), bool)
        if g.done:
            for st in slot.req.stop_tokens:
                if st < mask.shape[0]:
                    mask[st] = True
        logits = slot.last_logits.to(torch.float32)
        keep = torch.zeros(logits.shape[-1], dtype=torch.bool)
        keep[: mask.shape[0]] = torch.from_numpy(mask[: logits.shape[-1]])
        masked = torch.where(keep.to(logits.device), logits, -1e30)
        token = int(sample(masked[None, :], slot.key, slot.req.params, recent_counts=counts)[0])
        if token in slot.req.stop_tokens:
            return token
        g.accept_text(pieces[token] if token < len(pieces) else "")
        return token

    # -- the loop --------------------------------------------------------------

    def _fail(self, slots) -> None:
        """Roll back and release ``slots`` after a failed step (the
        reference's failed-ubatch rollback)."""
        for s in slots:
            if s.seq_id >= 0:
                try:
                    self.ctx.kv.seq_rm(s.seq_id)
                except ValueError:
                    pass
                s.seq_id = -1
            self._release(s, "error")

    def _loop(self):
        while not self._stop.is_set():
            try:
                did_work = self._iterate()
            except Exception:                                 # noqa: BLE001
                # an escaped error would kill the engine thread and leave
                # every HTTP request blocked on its queue: fail the in-flight
                # slots and keep serving
                traceback.print_exc()
                self._inflight = None
                self._fail([s for s in self.slots if s.state != SlotState.IDLE])
                did_work = True
            if not did_work:
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    @torch.inference_mode()
    def _iterate(self) -> bool:
        """One engine iteration; True when it did work."""
        ran_side = False
        while True:
            try:
                task = self._side.get_nowait()
            except queue.Empty:
                break
            task()
            ran_side = True

        # admit pending requests into free slots
        while True:
            slot = self._free_slot()
            if slot is None:
                break
            try:
                req = self.pending.get_nowait()
            except queue.Empty:
                break
            self._launch(slot, req)

        # context shift: drop the oldest half (keeping the first cell) when a
        # lane is about to overflow
        kv = self.ctx.kv
        for s in self.slots:
            if s.state == SlotState.GENERATING and s.seq_id >= 0:
                n = kv.lengths[kv.lane_of(s.seq_id)]
                if n >= kv.max_seq - 1:
                    if self.ctx.cfg.any_swa:
                        # no context shift over ring caches: finish at the limit
                        self._release(s, "length")
                        continue
                    n_keep = 1
                    try:
                        kv.seq_shift(self.ctx.cfg, s.seq_id, n_keep, max((n - n_keep) // 2, 1))
                    except RuntimeError:
                        # nor over a recurrent or hybrid memory
                        self._release(s, "length")
                        continue
                    if s.draft_seq >= 0:
                        # the draft cache cannot follow the shift (its
                        # positions would diverge): drop it, and the slot
                        # decodes one token a step from here on
                        self.draft_ctx.kv.seq_rm(s.draft_seq)
                        s.draft_seq = -1

        # 1) prompt chunks: several mid-prompt slots share one step (a slot
        # with a draft sequence prefills alone, the draft beside it)
        prompt_slots = [s for s in self.slots if s.state == SlotState.PROMPT]
        if prompt_slots:
            # a context without prefill_multi (recurrent, hybrid) prefills one
            # slot a step
            batchable = [s for s in prompt_slots if s.draft_seq < 0 and s.req.segments is None] \
                if hasattr(self.ctx, "prefill_multi") else []
            group = batchable if len(batchable) >= 2 else prompt_slots[:1]
            try:
                if len(group) >= 2:
                    self._prompt_step_multi(group)
                else:
                    self._prompt_step(group[0])
            except Exception:                                 # noqa: BLE001
                traceback.print_exc()
                self._fail(group)
            return True

        # 2) one batched decode for every GENERATING slot
        gen = [s for s in self.slots if s.state == SlotState.GENERATING]
        if not gen:
            return ran_side
        try:
            self._decode_step(gen)
        except Exception:                                     # noqa: BLE001
            traceback.print_exc()
            self._inflight = None
            self._fail(gen)
        return True

    def _finish_prompt(self, s: Slot, logits: torch.Tensor) -> None:
        s.last_logits = logits
        s.state = SlotState.GENERATING
        tok = self._sample_token(s)
        self._emit_probs(s, tok)
        if self._emit(s, tok):
            self._release(s, s.finish_reason)

    def _prompt_step_multi(self, slots) -> None:
        """One prompt chunk for several slots in one step (chunks padded to
        one bucket, each lane's final position gathered)."""
        max_chunk = min(self.PROMPT_CHUNK, self.ctx.max_chunk)
        chunks = {s.seq_id: list(s.req.prompt_tokens[s.prompt_pos: s.prompt_pos + max_chunk])
                  or [0] for s in slots}
        outs = self.ctx.prefill_multi(chunks)
        for s in slots:
            c = chunks[s.seq_id]
            s.prompt_pos += len(c)
            self.n_prompt_tokens += len(c)
            if s.prompt_pos >= len(s.req.prompt_tokens):
                self._finish_prompt(s, outs[s.seq_id])

    def _prompt_step(self, s: Slot) -> None:
        if s.req.segments is not None:
            # multimodal: one segment a step, tokens or an image chunk
            kind, payload = s.req.segments[s.prompt_pos]
            if kind == "embeds":
                logits = self.ctx.prefill_embeds(s.seq_id, payload)
            elif kind == "embeds_mrope":
                emb, grid = payload
                logits = self.ctx.prefill_embeds(s.seq_id, emb, mrope_grid=grid)
            else:
                logits = self.ctx.prefill(s.seq_id, list(payload) or [0], all_logits=False)
            self.n_prompt_tokens += _segment_rows((kind, payload))
            s.prompt_pos += 1
            if s.prompt_pos >= len(s.req.segments):
                self._finish_prompt(s, logits[-1])
            return
        chunk = s.req.prompt_tokens[s.prompt_pos: s.prompt_pos + self.PROMPT_CHUNK]
        if not chunk:
            chunk = [0]         # empty prompt: one placeholder token
        logits = self.ctx.prefill(s.seq_id, list(chunk), all_logits=False)
        if s.draft_seq >= 0:
            self.draft_ctx.prefill(s.draft_seq, list(chunk), all_logits=False)
        s.prompt_pos += len(chunk)
        self.n_prompt_tokens += len(chunk)
        if s.prompt_pos >= len(s.req.prompt_tokens):
            self._finish_prompt(s, logits[-1])

    # -- speculative decoding with a draft model ---------------------------

    def _spec_eligible(self, s: Slot) -> bool:
        """A speculative round suits the slot: a draft sequence, greedy, no
        grammar, penalties, DRY, mirostat or logprobs, a target memory that
        can rewind (not recurrent or hybrid), and room in both caches for the
        n_draft + 1 tokens a round feeds before the next context-shift
        check."""
        p = s.req.params
        if not (self.draft_ctx is not None and s.draft_seq >= 0 and p.temperature == 0.0
                and s.grammar is None and s.req.n_probs == 0 and p.penalty_repeat == 1.0
                and not p.penalty_freq and not p.penalty_present and not p.dry_multiplier
                and not p.mirostat and not self.ctx.cfg.is_recurrent
                and not self.ctx.cfg.is_hybrid):
            return False
        kv, dkv = self.ctx.kv, self.draft_ctx.kv
        return (kv.lengths[kv.lane_of(s.seq_id)] + self.n_draft + 1 <= kv.max_seq
                and dkv.lengths[dkv.lane_of(s.draft_seq)] + self.n_draft + 1 <= dkv.max_seq)

    def _decode_step_spec(self, s: Slot) -> None:
        """One speculative round: the draft proposes n_draft tokens greedily,
        the target verifies [last] + proposal in one chunked prefill, and
        both caches roll back to the accepted length."""
        last = s.generated[-1]
        kv, dkv = self.ctx.kv, self.draft_ctx.kv
        l0 = kv.lengths[kv.lane_of(s.seq_id)]
        d0 = dkv.lengths[dkv.lane_of(s.draft_seq)]
        proposal = []
        cur = last
        for _ in range(self.n_draft):
            cur = int(torch.argmax(self.draft_ctx.decode({s.draft_seq: cur})[s.draft_seq]))
            proposal.append(cur)
        self.n_drafted += len(proposal)
        logits = self.ctx.prefill(s.seq_id, [last] + proposal)
        want = torch.argmax(logits, dim=-1).tolist()
        accepted = []
        for i, p in enumerate(proposal):
            accepted.append(want[i])
            if want[i] != p:
                break
        else:
            accepted.append(want[len(proposal)])
        self.n_draft_accepted += sum(1 for i in range(min(len(accepted), len(proposal)))
                                     if accepted[i] == proposal[i])
        # both caches back to "everything fed but the newest token": the
        # target keeps l0 + len(accepted); the draft rewinds the whole round
        # and is fed [last] + accepted[:-1] again (its own proposals may part
        # from them after the first rejection)
        kv.seq_rm(s.seq_id, p0=l0 + len(accepted))
        dkv.seq_rm(s.draft_seq, p0=d0)
        self.draft_ctx.prefill(s.draft_seq, [last] + accepted[:-1], all_logits=False)
        s.last_logits = logits[min(len(accepted) - 1, len(proposal))]
        for tok in accepted:
            if self._emit(s, tok):
                self._release(s, s.finish_reason)
                return

    # -- the fast path: device-side decode runs ------------------------------

    def _fast_eligible(self, s: Slot) -> bool:
        """The slot can decode through the device run: every sampler of the
        chain has a device twin; mirostat v1 and n_probs > 128 do not;
        penalties with a window shorter than 2n cannot slide it for chained
        runs; a grammar slot needs its pieces (to be validated at flush);
        infill and draft slots take their own paths; the lane needs room for
        the whole run below the shift trigger. A context without a device
        decode run (recurrent, hybrid), and a lane whose positions leave its
        slots (``seq_div``, an M-RoPE image), decode step by step."""
        if not hasattr(self.ctx, "decode_run_start"):
            return False
        p = s.req.params
        n = self.ctx.DECODE_RUN_STEPS
        kv = self.ctx.kv
        lane = kv.lane_of(s.seq_id)
        if kv.slot_pos.get(lane) is not None or kv.mrope_delta.get(lane):
            return False
        if self.ctx._penalties_active(p) and 0 <= p.penalty_last_n < 2 * n:
            return False
        if s.grammar is not None and not s.req.token_pieces:
            return False
        if p.mirostat and p.mirostat != 2:
            return False
        if s.req.n_probs > 128:
            return False
        return (s.draft_seq < 0 and not s.req.infill and p.top_k <= 128
                and kv.lengths[kv.lane_of(s.seq_id)] + n + 1 < kv.max_seq)

    @staticmethod
    def _dfa_key(req) -> tuple:
        return (getattr(req.grammar, "gbnf", "") or id(req.grammar),
                len(req.token_pieces or ()))

    def _slot_dfa(self, s: Slot):
        """(TokenDFA, state row) when the slot's grammar has a compiled DFA
        and its current host PDA state maps to a row; else None."""
        g = s.grammar
        if g is None or getattr(g, "awaiting_trigger", False):
            return None
        with _DFA_LOCK:
            dfa = _DFA_CACHE.get(self._dfa_key(s.req))
        if dfa is None:
            return None
        row = dfa.index_of(g)
        return (dfa, row) if row >= 0 else None

    def _dfa_device(self, dfa):
        """(masks, trans) of a TokenDFA on this context's device, uploaded
        once and padded to the model's vocabulary (a pad column is illegal
        and leads nowhere)."""
        dev = getattr(dfa, "_dev", None)
        if dev is None:
            v = self.ctx.cfg.vocab_size
            m, t = dfa.masks, dfa.trans
            if m.shape[1] < v:
                pad = v - m.shape[1]
                m = np.pad(m, ((0, 0), (0, pad)))
                t = np.pad(t, ((0, 0), (0, pad)), constant_values=-1)
            dev = dfa._dev = (self.ctx._upload(np.ascontiguousarray(m[:, :v])),
                              self.ctx._upload(np.ascontiguousarray(t[:, :v])))
        return dev

    def _dispatch_fast(self, gen: list, chain=None) -> dict:
        """Enqueue one device run (DECODE_RUN_STEPS tokens per slot);
        returns the in-flight record. A fresh run carries the token DFA when
        every grammar slot of it has the same compiled one."""
        dfa_arg = None
        if chain is None:
            gslots = [s for s in gen if s.grammar is not None]
            if gslots:
                infos = [self._slot_dfa(s) for s in gslots]
                if all(i is not None for i in infos) and len({id(i[0]) for i in infos}) == 1:
                    gm, gt = self._dfa_device(infos[0][0])
                    dfa_arg = (gm, gt, {s.seq_id: i[1] for s, i in zip(gslots, infos)})
        handle = self.ctx.decode_run_start(
            {s.seq_id: (s.generated[-1] if chain is None else None) for s in gen},
            {s.seq_id: s.key for s in gen},
            {s.seq_id: s.req.params for s in gen},
            chain=chain,
            histories={s.seq_id: s.generated for s in gen},
            mus={s.seq_id: s.mirostat_mu for s in gen if s.req.params.mirostat},
            dfa=dfa_arg)
        self.n_decode_runs += 1
        self.n_dfa_runs += int(handle["feats"][5])
        kv = self.ctx.kv
        # keyed by (seq_id, request id): a released lane keeps its seq_id as
        # a prompt cache, so a later request on it must not match this run
        items = {(s.seq_id, s.req.id): kv.lengths[kv.lane_of(s.seq_id)] - handle["n"]
                 for s in gen}
        return {"handle": handle, "items": items}

    def _flush_fast(self, inf: dict) -> None:
        """Read a run's tokens (one readback, the candidate rows with it when
        a slot validates a grammar or reports logprobs) and emit them. Slots
        released while the run was in flight are skipped; the run's extra
        cache writes sit past the rewound length and are overwritten on
        reuse.

        A grammar slot's tokens are validated against its host PDA here. A
        run without the DFA samples freely, so a token may break the
        grammar: it is resampled from the run's captured top-128 candidates
        (its step's KV cell holds the previous, accepted token, so nothing
        on the device needs redoing), or, with no legal candidate there, the
        cache rewinds one token and the host chain masks and resamples.
        Chaining waits while a grammar slot may rewind (``_decode_step``)."""
        h = inf["handle"]
        toks = h["toks"].cpu().numpy()
        cands = None
        if any(s.state == SlotState.GENERATING and s.req is not None
               and (s.seq_id, s.req.id) in inf["items"]
               and (s.grammar is not None or (s.req.n_probs > 0 and s.req.on_probs is not None))
               for s in self.slots):
            cands = (h["cand_v"].cpu().numpy(), h["cand_i"].cpu().numpy())
        for (seq_id, req_id), base in inf["items"].items():
            slot = next((s for s in self.slots
                         if s.seq_id == seq_id and s.state == SlotState.GENERATING
                         and s.req is not None and s.req.id == req_id), None)
            if slot is None:
                continue
            lane = h["lanes"][seq_id]
            slot.key = h["gens"][lane]
            for i, tok in enumerate(toks[lane].tolist()):
                if slot.grammar is not None and not self._grammar_accepts(slot, tok):
                    self.n_resampled += 1
                    cv, ci = cands[0][lane, i], cands[1][lane, i]
                    tok2 = self._resample_from_candidates(
                        slot, cv, ci, seed=slot.key.initial_seed() ^ (base + i))
                    if tok2 is not None:
                        self.ctx.kv.seq_rm(seq_id, p0=base + i + 1)
                        self._emit_probs_fast(slot, tok2, cv, ci)
                        if self._emit(slot, tok2):
                            self._release(slot, slot.finish_reason)
                        break
                    # no legal candidate in the top 128: the full host path
                    self.ctx.kv.seq_rm(seq_id, p0=base + i)
                    slot.last_logits = self.ctx.decode({seq_id: slot.generated[-1]})[seq_id]
                    tok = self._sample_token(slot)
                    self._emit_probs(slot, tok)
                    if self._emit(slot, tok):
                        self._release(slot, slot.finish_reason)
                    break
                if cands is not None:
                    self._emit_probs_fast(slot, tok, cands[0][lane, i], cands[1][lane, i])
                if self._emit(slot, tok):
                    # the cache holds the tokens fed through step i: rewind
                    # the overshoot past the accepted token
                    self.ctx.kv.seq_rm(seq_id, p0=base + i + 1)
                    self._release(slot, slot.finish_reason)
                    break

    def _resample_from_candidates(self, slot: Slot, vals, ids, seed: int):
        """A grammar violation's resample over the run's captured top-128
        candidate row: device_sample's temperature / top-k / top-p / min-p
        with the grammar's legality mask, a Gumbel draw seeded with
        ``seed``; advances the PDA with the pick and returns it, or None when
        no candidate is legal. Host NumPy only."""
        g = slot.grammar
        pieces = slot.req.token_pieces
        p = slot.req.params
        ids = np.asarray(ids)
        legal = np.zeros(len(ids), bool)
        for j, tid in enumerate(ids.tolist()):
            if tid in slot.req.stop_tokens:
                legal[j] = g.done
            else:
                piece = pieces[tid] if tid < len(pieces) else ""
                legal[j] = bool(piece) and g.accepts_text(piece)
        if not legal.any():
            return None
        v = np.asarray(vals, np.float64)
        k = min(p.top_k, len(ids)) if p.top_k > 0 else len(ids)
        allowed = np.arange(len(ids)) < k
        t = p.temperature if p.temperature > 0 else 1.0
        scaled = np.where(allowed, v / t, -np.inf)
        e = np.exp(scaled - scaled.max())
        probs = e / e.sum()
        cum = np.cumsum(probs)
        keep = allowed & ((cum - probs) < p.top_p) & (probs >= p.min_p * probs.max())
        keep[0] = True
        final = keep & legal
        if not final.any():
            final = legal               # the filters excluded every legal one
        if p.temperature <= 0:
            j = int(np.argmax(np.where(final, v, -np.inf)))
        else:
            # unfiltered logits: a legal candidate past top-k has none in
            # ``scaled``, and the draw must still land on a legal one
            gum = np.random.default_rng(seed & 0x7FFFFFFF).gumbel(size=len(ids))
            j = int(np.argmax(np.where(final, v / t, -np.inf) + gum))
        tok = int(ids[j])
        if tok not in slot.req.stop_tokens:
            g.accept_text(pieces[tok] if tok < len(pieces) else "")
        return tok

    def _grammar_accepts(self, slot: Slot, token: int) -> bool:
        """Advance the slot's grammar with ``token`` if it is legal (the
        accept arm of ``_grammar_check``); False is a violation."""
        g = slot.grammar
        pieces = slot.req.token_pieces
        piece = pieces[token] if pieces and token < len(pieces) else ""
        if getattr(g, "awaiting_trigger", False):
            g.feed_token(token, piece)        # unconstrained until the trigger
            return True
        if token in slot.req.stop_tokens:
            return g.done                     # EOS only once the grammar can end
        return bool(piece) and g.accept_text(piece)

    def _decode_step(self, gen: list) -> None:
        # pipelined runs: enqueue run N+1, chained on run N's device outputs,
        # before reading run N, so the host's readback and emitting overlap
        # the device's work. A grammar slot validates (and may rewind) run N
        # first, unless run N carried the DFA: its tokens are legal by
        # construction, so no rewind can undo the chain.
        if self._inflight is not None:
            prev, self._inflight = self._inflight, None
            if (set(prev["items"]) == {(s.seq_id, s.req.id) for s in gen}
                    and all(self._fast_eligible(s) for s in gen)
                    and (all(s.grammar is None for s in gen) or prev["handle"]["feats"][5])):
                self._inflight = self._dispatch_fast(gen, chain=prev["handle"])
                self._flush_fast(prev)
                return
            self._flush_fast(prev)
            gen = [s for s in self.slots if s.state == SlotState.GENERATING]
            if not gen:
                return
        if len(gen) == 1 and self._spec_eligible(gen[0]):
            self._decode_step_spec(gen[0])
            return
        if all(self._fast_eligible(s) for s in gen):
            self._inflight = self._dispatch_fast(gen)
            return
        out = self.ctx.decode({s.seq_id: s.generated[-1] for s in gen})
        for s in gen:
            s.last_logits = out[s.seq_id]
            tok = self._sample_token(s)
            self._emit_probs(s, tok)
            if self._emit(s, tok):
                self._release(s, s.finish_reason)
