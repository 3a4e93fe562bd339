"""Chain-composable samplers on the host path.

Port of ``SamplerParams`` and the host ``sample`` chain of
``rrs_tpu/runtime/sampler.py``. The transforms are torch ops on the logits'
device; the random draws come from an explicit ``torch.Generator`` on the
CPU, so a seed gives the same tokens on any device (they differ from
``jax.random``'s). The on-device twins used by serving wait for that slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplerParams:
    temperature: float = 1.0
    top_k: int = 0                  # 0 = disabled
    top_p: float = 1.0
    min_p: float = 0.0
    typical_p: float = 1.0
    penalty_repeat: float = 1.0
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    penalty_last_n: int = 64
    seed: int = 42
    xtc_probability: float = 0.0
    xtc_threshold: float = 0.1
    top_n_sigma: float = 0.0        # 0 = disabled
    mirostat: int = 0               # 0 off, 2 = mirostat v2
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    logit_bias: tuple = ()          # ((token_id, bias), ...)
    dry_multiplier: float = 0.0
    dry_base: float = 1.75
    dry_allowed_length: int = 2

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def _neg_inf_like(x: torch.Tensor) -> torch.Tensor:
    return torch.full_like(x, NEG_INF)


def apply_penalties(logits: torch.Tensor, recent_counts: torch.Tensor,
                    p: SamplerParams) -> torch.Tensor:
    """Repetition/frequency/presence penalties (llama_sampler_penalties)."""
    if p.penalty_repeat == 1.0 and p.penalty_freq == 0.0 and p.penalty_present == 0.0:
        return logits
    counts = recent_counts.to(logits.dtype)
    present = counts > 0
    if p.penalty_repeat != 1.0:
        pen = torch.where(logits > 0, logits / p.penalty_repeat, logits * p.penalty_repeat)
        logits = torch.where(present, pen, logits)
    return logits - counts * p.penalty_freq - present.to(logits.dtype) * p.penalty_present


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, _neg_inf_like(logits), logits)


def apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    if top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < top_p        # always keeps the first
    threshold = torch.where(keep, sorted_logits, torch.full_like(sorted_logits, float("inf"))
                            ).amin(dim=-1, keepdim=True)
    return torch.where(logits < threshold, _neg_inf_like(logits), logits)


def apply_min_p(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    if min_p <= 0.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    cutoff = probs.amax(dim=-1, keepdim=True) * min_p
    return torch.where(probs < cutoff, _neg_inf_like(logits), logits)


def apply_typical(logits: torch.Tensor, typ_p: float) -> torch.Tensor:
    """Locally typical sampling (llama_sampler_typical)."""
    if typ_p >= 1.0:
        return logits
    log_probs = torch.log_softmax(logits, dim=-1)
    probs = log_probs.exp()
    entropy = -(probs * log_probs).sum(dim=-1, keepdim=True)
    shifted = (-log_probs - entropy).abs()
    order = torch.argsort(shifted, dim=-1, stable=True)
    probs_sorted = torch.gather(probs, -1, order)
    cum = torch.cumsum(probs_sorted, dim=-1)
    keep_sorted = cum - probs_sorted < typ_p
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return torch.where(keep, logits, _neg_inf_like(logits))


def apply_xtc(logits: torch.Tensor, gen: torch.Generator, p: SamplerParams) -> torch.Tensor:
    """XTC: with probability xtc_probability, drop every token whose prob
    exceeds the threshold except the least likely of them."""
    if p.xtc_probability <= 0.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    over = probs >= p.xtc_threshold
    n_over = over.sum(dim=-1, keepdim=True)
    min_over = torch.where(over, probs, torch.full_like(probs, float("inf"))).amin(
        dim=-1, keepdim=True)
    drop = over & (probs > min_over) & (n_over >= 2)
    u = torch.rand(logits.shape[:-1] + (1,), generator=gen).to(logits.device)
    return torch.where(drop & (u < p.xtc_probability), _neg_inf_like(logits), logits)


def apply_top_n_sigma(logits: torch.Tensor, n_sigma: float) -> torch.Tensor:
    """top-n-sigma: keep logits within n * std of the max."""
    if n_sigma <= 0.0:
        return logits
    valid = logits > NEG_INF / 2
    cnt = valid.sum(dim=-1, keepdim=True)
    zero = torch.zeros_like(logits)
    mean = torch.where(valid, logits, zero).sum(dim=-1, keepdim=True) / cnt
    var = (torch.where(valid, logits - mean, zero) ** 2).sum(dim=-1, keepdim=True) / cnt
    cutoff = logits.amax(dim=-1, keepdim=True) - n_sigma * var.sqrt()
    return torch.where(logits < cutoff, _neg_inf_like(logits), logits)


def apply_logit_bias(logits: torch.Tensor, bias: tuple) -> torch.Tensor:
    logits = logits.clone()
    for tid, b in bias:
        logits[..., int(tid)] += float(b)
    return logits


def sample(logits: torch.Tensor, gen: torch.Generator, p: SamplerParams,
           recent_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply the sampler chain to logits [B, V] and draw one token per row.
    Returns int64 [B] on the CPU."""
    logits = logits.to(torch.float32)
    if p.logit_bias:
        logits = apply_logit_bias(logits, p.logit_bias)
    if recent_counts is not None:
        logits = apply_penalties(logits, recent_counts.to(logits.device), p)
    if p.greedy:
        return torch.argmax(logits, dim=-1).cpu()
    logits = logits / max(p.temperature, 1e-6)
    logits = apply_xtc(logits, gen, p)
    logits = apply_top_n_sigma(logits, p.top_n_sigma)
    logits = apply_top_k(logits, p.top_k)
    logits = apply_typical(logits, p.typical_p)
    logits = apply_top_p(logits, p.top_p)
    logits = apply_min_p(logits, p.min_p)
    probs = torch.softmax(logits, dim=-1).cpu()
    return torch.multinomial(probs, 1, generator=gen)[:, 0]
