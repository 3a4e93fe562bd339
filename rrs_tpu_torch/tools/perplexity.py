"""Perplexity, KL divergence and multiple-choice scoring (the perplexity tool
analog) on the port.

Port of ``rrs_tpu/tools/perplexity.py``: the windowed NLL protocol (the
token stream cut into chunks of ``n_ctx``; in each, the first
min(n_ctx/2, 512) positions warm the context and the NLL accumulates from
there on; PPL = exp(mean NLL)), with the target log-probs on the device
(``ctx.prefill_logprobs``) or, as the JAX host branch does, from the full
logits in float64 on the host; the common-prefix choice scoring of
HellaSwag, Winogrande and the multiple-choice (MMLU) format; KL(base ||
model) against saved logits; the three dataset loaders; and
``compute_perplexity_pp``, the same protocol over a pipeline of layer-split
stages (``parallel/pipeline.py``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class PerplexityResult:
    ppl: float
    nll_sum: float
    n_tokens: int
    per_chunk: list[float]


def _log_softmax_row(logits: np.ndarray, target: int) -> float:
    m = logits.max()
    lse = m + math.log(np.exp(logits - m).sum())
    return float(logits[target] - lse)


def host_logits(ctx, tokens: list[int]) -> np.ndarray:
    """Prefill a fresh sequence and read its logits [T, V] back as f32 NumPy."""
    seq = ctx.new_sequence()
    try:
        return ctx.prefill(seq, tokens).float().cpu().numpy()
    finally:
        ctx.kv.seq_rm(seq)


def compute_perplexity(ctx, tokens: list[int], n_ctx: int = 512, progress: bool = False,
                       device_nll: bool = True) -> PerplexityResult:
    """Sliding-chunk perplexity over a token stream. ``device_nll``: the
    log-softmax and the gather of the targets run on the device and only [T]
    log-probs come back; else the [T, V] logits come back and each row's
    log-softmax is taken in float64 on the host."""
    first = min(n_ctx // 2, 512)
    nll = 0.0
    count = 0
    per_chunk = []
    n_chunks = max(0, len(tokens) // n_ctx)
    for c in range(n_chunks):
        chunk = tokens[c * n_ctx: (c + 1) * n_ctx]
        if device_nll:
            seq = ctx.new_sequence()
            try:
                lp = ctx.prefill_logprobs(seq, chunk, chunk[1:] + [0])
            finally:
                ctx.kv.seq_rm(seq)
            sel = lp[first: len(chunk) - 1]
            chunk_nll = -float(sel.sum())
            chunk_count = len(sel)
        else:
            logits = host_logits(ctx, chunk)
            chunk_nll = 0.0
            chunk_count = 0
            for i in range(first, len(chunk) - 1):
                chunk_nll -= _log_softmax_row(logits[i].astype(np.float64), chunk[i + 1])
                chunk_count += 1
        nll += chunk_nll
        count += chunk_count
        per_chunk.append(math.exp(chunk_nll / max(chunk_count, 1)))
        if progress:
            print(f"[{c + 1}/{n_chunks}] ppl so far: {math.exp(nll / count):.4f}", flush=True)
    return PerplexityResult(ppl=math.exp(nll / max(count, 1)), nll_sum=nll, n_tokens=count,
                            per_chunk=per_chunk)


def compute_perplexity_pp(cfg, weights, tokens: list[int], mesh, n_ctx: int = 512,
                          n_micro: int = 2, progress: bool = False) -> PerplexityResult:
    """Perplexity over a pipeline-parallel (layer-split) mesh, as
    rrs_tpu/tools/perplexity.py:88-125: each step pushes n_micro chunks
    through the GPipe schedule (the last step padded with copies of its last
    chunk); the NLL protocol of ``compute_perplexity``, each row's
    log-softmax in float64 (on the device; only the [T] target log-probs
    come back)."""
    import torch

    from rrs_tpu_torch.parallel.pipeline import make_pipeline_forward

    first = min(n_ctx // 2, 512)
    n_chunks = len(tokens) // n_ctx
    fn = make_pipeline_forward(cfg, weights, mesh, b=n_micro, t=n_ctx, n_micro=n_micro)
    positions = np.broadcast_to(np.arange(n_ctx, dtype=np.int32), (n_micro, n_ctx)).copy()
    nll = 0.0
    count = 0
    per_chunk = []
    for base in range(0, n_chunks, n_micro):
        batch = [tokens[c * n_ctx:(c + 1) * n_ctx]
                 for c in range(base, min(base + n_micro, n_chunks))]
        real = len(batch)
        batch += [batch[-1]] * (n_micro - real)
        logits = fn(np.asarray(batch, np.int64), positions)
        tgt = torch.as_tensor(np.asarray(batch, np.int64)[:, first + 1:], device=logits.device)
        lp = torch.log_softmax(logits[:, first:n_ctx - 1].to(torch.float64), dim=-1)
        lp = torch.gather(lp, -1, tgt[:, :, None])[:, :, 0].cpu().numpy()
        for r in range(real):
            chunk_nll = -float(lp[r].sum())
            chunk_count = lp.shape[1]
            nll += chunk_nll
            count += chunk_count
            per_chunk.append(math.exp(chunk_nll / max(chunk_count, 1)))
        if progress:
            print(f"[{len(per_chunk)}/{n_chunks}] ppl so far: "
                  f"{math.exp(nll / max(count, 1)):.4f}", flush=True)
    return PerplexityResult(ppl=math.exp(nll / max(count, 1)), nll_sum=nll, n_tokens=count,
                            per_chunk=per_chunk)


def score_choice(ctx, prefix_tokens: list[int], choice_tokens: list[int]) -> float:
    """Total log-prob of ``choice_tokens`` given ``prefix_tokens`` (the
    common-prefix scoring core of the HellaSwag / Winogrande / MMLU
    evaluators), from the device log-probs."""
    toks = prefix_tokens + choice_tokens
    seq = ctx.new_sequence()
    try:
        lp_all = ctx.prefill_logprobs(seq, toks, toks[1:] + [0])
    finally:
        ctx.kv.seq_rm(seq)
    return float(lp_all[len(prefix_tokens) - 1: len(toks) - 1].sum())


def multiple_choice_score(ctx, vocab, tasks, normalize_length: bool = True):
    """tasks: [{"prompt": str, "choices": [str...], "answer": int}]. Returns
    (accuracy, per-task picks), by length-normalized log-prob (the HellaSwag
    convention)."""
    n_correct = 0
    picks = []
    for task in tasks:
        prefix = vocab.encode(task["prompt"], add_special=True)
        best, best_score = -1, -1e30
        for ci, choice in enumerate(task["choices"]):
            ctoks = vocab.encode(choice, add_special=False)
            if not ctoks:
                continue
            s = score_choice(ctx, prefix, ctoks)
            if normalize_length:
                s /= len(ctoks)
            if s > best_score:
                best, best_score = ci, s
        picks.append(best)
        if best == int(task["answer"]):
            n_correct += 1
    return n_correct / max(len(tasks), 1), picks


def kl_divergence(ctx, base_logits_per_pos: np.ndarray, tokens: list[int]):
    """Mean KL(base || model) over positions and the same-top-token rate,
    given the base model's full logits [T, V] (the --kl-divergence-base
    flow), in float64 on the host."""
    logits = host_logits(ctx, tokens[: base_logits_per_pos.shape[0]])
    n = min(logits.shape[0], base_logits_per_pos.shape[0])
    kls = []
    same_top = 0
    for i in range(n):
        p = base_logits_per_pos[i].astype(np.float64)
        q = logits[i].astype(np.float64)
        p = p - p.max()
        q = q - q.max()
        lp = p - np.log(np.exp(p).sum())
        lq = q - np.log(np.exp(q).sum())
        kls.append(float((np.exp(lp) * (lp - lq)).sum()))
        same_top += int(p.argmax() == q.argmax())
    return {"mean_kl": float(np.mean(kls)), "max_kl": float(np.max(kls)),
            "same_top_rate": same_top / max(n, 1), "n_pos": n}


# ---------------------------------------------------------------------------
# Benchmark-task loaders (the reference perplexity tool's dataset formats)
# ---------------------------------------------------------------------------

def load_hellaswag(text: str) -> list[dict]:
    """HellaSwag datafile: 6 lines per task (context, gold ending index, 4
    endings). Returns generic multiple-choice tasks, endings with a leading
    space (the lm-eval preprocessing the reference mirrors)."""
    lines = text.split("\n")
    while lines and not lines[-1].strip():
        lines.pop()
    if len(lines) % 6:
        raise ValueError(f"hellaswag file: {len(lines)} lines, not a multiple of 6")
    return [{"prompt": lines[i], "answer": int(lines[i + 1]),
             "choices": [" " + lines[i + 2 + j] for j in range(4)]}
            for i in range(0, len(lines), 6)]


def _subset(tasks: list[dict], n_tasks: int) -> list[dict]:
    """A deterministic random subset of n_tasks (all when 0 or more)."""
    if n_tasks and n_tasks < len(tasks):
        idx = np.random.default_rng(1).permutation(len(tasks))[:n_tasks]
        tasks = [tasks[i] for i in idx]
    return tasks


def hellaswag_score(ctx, vocab, tasks: list[dict], n_tasks: int = 0,
                    progress: bool = False) -> float:
    """acc_norm over (a deterministic random subset of) HellaSwag tasks:
    length-normalized ending log-prob, argmax against the gold ending."""
    import sys

    tasks = _subset(tasks, n_tasks)
    n_correct = 0
    for ti, task in enumerate(tasks):
        acc, _ = multiple_choice_score(ctx, vocab, [task])
        n_correct += int(acc > 0.5)
        if progress:
            print(f"[{ti + 1}/{len(tasks)}] hellaswag acc so far: "
                  f"{n_correct / (ti + 1):.4f}", file=sys.stderr, flush=True)
    return n_correct / max(len(tasks), 1)


def load_winogrande(csv_text: str) -> list[dict]:
    """Winogrande CSV: index,sentence,choice1,choice2,answer; the sentence
    holds a '_' blank and the answer is 1 or 2."""
    import csv
    import io

    out = []
    for row in csv.reader(io.StringIO(csv_text)):
        if len(row) < 5:
            continue
        _, sentence, c1, c2, answer = row[:5]
        if "_" not in sentence:
            continue
        out.append({"sentence": sentence, "choices": [c1, c2], "answer": int(answer)})
    return out


def winogrande_score(ctx, vocab, tasks: list[dict], n_tasks: int = 0,
                     progress: bool = False) -> float:
    """Fill the blank with each choice and compare the log-likelihood of the
    trailing context given the filled prefix (the same tail for both
    choices, so no length normalization)."""
    import sys

    tasks = _subset(tasks, n_tasks)
    n_correct = 0
    for ti, task in enumerate(tasks):
        pre, post = task["sentence"].split("_", 1)
        scores = []
        for choice in task["choices"]:
            prefix = vocab.encode(pre + choice, add_special=True)
            tail = vocab.encode(post, add_special=False) or vocab.encode(".", add_special=False)
            scores.append(score_choice(ctx, prefix, tail))
        pick = 1 if scores[0] >= scores[1] else 2
        n_correct += int(pick == task["answer"])
        if progress:
            print(f"[{ti + 1}/{len(tasks)}] winogrande acc so far: "
                  f"{n_correct / (ti + 1):.4f}", file=sys.stderr, flush=True)
    return n_correct / max(len(tasks), 1)


def load_multiple_choice_bin(data: bytes) -> list[dict]:
    """The reference's serialized multiple-choice format (MMLU etc.): u32
    n_task, u32 task_pos[n_task], then per task the question and mc1 {u32 n,
    n strings, n i32 labels} and mc2 (the same, unused). Strings are
    u32-length-prefixed UTF-8."""
    import struct

    off = 0

    def u32():
        nonlocal off
        (v,) = struct.unpack_from("<I", data, off)
        off += 4
        return v

    def s():
        nonlocal off
        n = u32()
        v = data[off:off + n].decode("utf-8", errors="replace")
        off += n
        return v

    n_task = u32()
    off += 4 * n_task                      # task_pos (read sequentially instead)
    tasks = []
    for _ in range(n_task):
        question = s()
        out = {}
        for which in ("mc1", "mc2"):
            n = u32()
            answers = [s() for _ in range(n)]
            labels = list(struct.unpack_from(f"<{n}i", data, off))
            off += 4 * n
            out[which] = (answers, labels)
        answers, labels = out["mc1"]
        gold = labels.index(1) if 1 in labels else 0
        tasks.append({"prompt": question, "choices": [" " + a for a in answers],
                      "answer": gold})
    return tasks
