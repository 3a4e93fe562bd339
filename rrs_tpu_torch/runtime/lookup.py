"""Prompt-lookup (n-gram) speculative decoding — the common/ngram-cache.cpp
(+ examples/lookup) analog: draft tokens come from matching the most recent
n-gram against earlier context instead of a draft model, verified by the
target in one chunked step (the same verify/rollback loop as
runtime.speculative).

Port of ``rrs_tpu/runtime/lookup.py``; ``NGramCache.save`` / ``load`` keep
its JSON file format, so a cache file moves between the two packages.
"""

from __future__ import annotations

import dataclasses
from collections import Counter, defaultdict

import torch

from rrs_tpu_torch.runtime.speculative import SpecStats


class NGramCache:
    """n-gram -> next-token frequency maps for n in [n_min, n_max]
    (common_ngram_cache_update analog)."""

    def __init__(self, n_min: int = 1, n_max: int = 4):
        self.n_min = n_min
        self.n_max = n_max
        self.maps: dict[int, dict[tuple, Counter]] = {
            n: defaultdict(Counter) for n in range(n_min, n_max + 1)
        }
        self._history: list[int] = []

    def update(self, tokens: list[int]) -> None:
        """Extend the history and index new n-grams."""
        h = self._history
        start = len(h)
        h.extend(tokens)
        for n in range(self.n_min, self.n_max + 1):
            lo = max(n, start)            # first new complete ngram end
            for end in range(lo, len(h)):
                key = tuple(h[end - n : end])
                self.maps[n][key][h[end]] += 1

    def draft(self, n_draft: int) -> list[int]:
        """Greedily extend the current history tail (longest-match-first,
        common_ngram_cache_draft's static strategy)."""
        out: list[int] = []
        tail = list(self._history)
        for _ in range(n_draft):
            nxt = None
            for n in range(self.n_max, self.n_min - 1, -1):
                if len(tail) < n:
                    continue
                key = tuple(tail[-n:])
                counts = self.maps[n].get(key)
                if counts:
                    tok, cnt = counts.most_common(1)[0]
                    # require some confidence for short grams
                    if n > 1 or cnt >= 2:
                        nxt = tok
                        break
            if nxt is None:
                break
            out.append(nxt)
            tail.append(nxt)
        return out

    def save(self, path) -> None:
        import json

        data = {str(n): {" ".join(map(str, k)): dict(v)
                         for k, v in m.items()}
                for n, m in self.maps.items()}
        with open(path, "w") as f:
            json.dump(data, f)

    @classmethod
    def load(cls, path, n_min: int = 1, n_max: int = 4) -> "NGramCache":
        import json

        c = cls(n_min, n_max)
        with open(path) as f:
            data = json.load(f)
        for n_str, m in data.items():
            n = int(n_str)
            if n not in c.maps:
                continue
            for k, counts in m.items():
                key = tuple(int(x) for x in k.split())
                for tok, cnt in counts.items():
                    c.maps[n][key][int(tok)] += cnt
        return c


def generate_lookup(
    target,
    prompt: list[int],
    max_new_tokens: int,
    n_draft: int = 8,
    stop_tokens: tuple[int, ...] = (),
    cache: NGramCache | None = None,
) -> tuple[list[int], SpecStats]:
    """Greedy prompt-lookup generation (examples/lookup/lookup.cpp loop)."""
    stats = SpecStats()
    cache = cache or NGramCache()
    cache.update(list(prompt))

    seq = target.new_sequence()
    logits = target.prefill(seq, prompt)
    out: list[int] = []
    last = int(torch.argmax(logits[-1]))
    out.append(last)
    cache.update([last])

    while len(out) < max_new_tokens and last not in stop_tokens:
        proposal = cache.draft(n_draft)
        if not proposal:
            dl = target.decode({seq: last})[seq]
            last = int(torch.argmax(dl))
            out.append(last)
            cache.update([last])
            continue
        stats.n_drafted += len(proposal)
        verify = [last] + proposal
        logits = target.prefill(seq, verify)
        want = torch.argmax(logits, dim=-1).tolist()
        accepted = []
        for i, p in enumerate(proposal):
            if want[i] == p:
                accepted.append(p)
            else:
                accepted.append(want[i])
                break
        else:
            accepted.append(want[len(proposal)])
        stats.n_accepted += sum(
            1 for i, p in enumerate(proposal[: len(accepted)])
            if accepted[i] == p)
        keep = len(prompt) + len(out) + len(accepted) - 1
        target.kv.seq_rm(seq, p0=keep)
        for tok in accepted:
            out.append(tok)
            cache.update([tok])
            last = tok
            if last in stop_tokens or len(out) >= max_new_tokens:
                break
    target.kv.seq_rm(seq)
    return out[:max_new_tokens], stats
