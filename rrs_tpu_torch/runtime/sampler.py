"""Chain-composable samplers: the host chain and its on-device twins.

Port of ``rrs_tpu/runtime/sampler.py``: ``SamplerParams``, the host ``sample``
chain with ``mirostat_v2_sample`` and ``dry_penalties``, and the per-lane
``device_*`` transforms, ``topk_candidates`` and ``device_sample`` that the
serving decode run applies to [B, V] logits without leaving the device. None
of these is a TPU kernel: they are plain torch ops on the logits' device.

Random draws come from explicit ``torch.Generator``s, on the generator's own
device, never from the global RNG. ``jax.random`` and ``torch.Generator`` are
different streams, so a seed does not give the JAX package's tokens: the
tests hold greedy picks to identical tokens and sampled draws to the JAX
chain's support. The device twins take one generator per lane (``None`` for
a lane with no sequence, whose draw is discarded). ``infill_sample`` is the
fill-in-the-middle sampler of the ``/infill`` route.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
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
    u = torch.rand(logits.shape[:-1] + (1,), generator=gen, device=gen.device).to(logits.device)
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


def mirostat_v2_sample(logits, gen: torch.Generator, mu: float,
                       p: SamplerParams) -> tuple[int, float]:
    """Mirostat v2 (llama_sampler_mirostat_v2) on one host row [V]: truncate
    tokens with surprise > mu, sample, then move mu toward tau."""
    lg = np.asarray(logits, np.float64) / max(p.temperature, 1e-6)
    lg -= lg.max()
    probs = np.exp(lg)
    probs /= probs.sum()
    surprise = -np.log2(np.maximum(probs, 1e-30))
    keep = surprise <= mu
    if not keep.any():
        keep[np.argmax(probs)] = True
    pk = np.where(keep, probs, 0.0)
    pk /= pk.sum()
    u = float(torch.rand((), generator=gen, device=gen.device))
    token = min(int(np.searchsorted(np.cumsum(pk), u)), len(pk) - 1)
    return token, mu - p.mirostat_eta * (float(surprise[token]) - p.mirostat_tau)


def infill_sample(logits, pieces: list[str], eog_ids: set, gen: torch.Generator,
                  k_max: int = 64, thold: float = 0.2) -> int:
    """Fill-in-the-middle sampler (llama_sampler_init_infill) on one host row
    [V] of logits, over its top ``k_max`` candidates:
      1. if EOG mass dominates (3 * p_eog * n > p_txt) sample among EOG only;
      2. merge tokens whose piece is a prefix of another candidate's piece
         into the more probable one;
      3. drop non-EOG tokens below the ``thold`` probability threshold;
      4. if nothing non-EOG survives, emit EOG deterministically.
    The one uniform draw comes from ``gen``."""
    x = np.asarray(logits, np.float64)
    v = x.shape[-1]
    x = x - x.max()
    p_full = np.exp(x)
    p_full /= p_full.sum()
    k = min(k_max, v)
    cand = np.argpartition(-p_full, k - 1)[:k]
    cand = cand[np.argsort(-p_full[cand])]
    probs = p_full[cand].copy()
    is_eog = np.asarray([int(c) in eog_ids for c in cand])
    p_eog = probs[is_eog].sum()
    p_txt = probs[~is_eog].sum()

    def draw(ids, ps):
        ps = np.maximum(ps, 0)
        tot = ps.sum()
        if tot <= 0 or len(ids) == 1:
            return int(ids[0])
        r = float(torch.rand((), generator=gen, device=gen.device))
        return int(ids[np.searchsorted(np.cumsum(ps / tot), r)])

    if p_eog > 0 and 3.0 * p_eog * len(cand) > p_txt:
        return draw(cand[is_eog], probs[is_eog])
    # combine common-prefix tokens into the more probable one
    texts = [pieces[int(c)] if int(c) < len(pieces) else "" for c in cand]
    alive = np.ones(len(cand), bool)
    for i0 in range(len(cand)):
        for i1 in range(len(cand)):
            if i0 == i1 or not alive[i0] or not alive[i1]:
                continue
            t0, t1 = texts[i0], texts[i1]
            if t0 and len(t0) <= len(t1) and t1.startswith(t0):
                dst, src = (i0, i1) if probs[i0] >= probs[i1] else (i1, i0)
                probs[dst] += probs[src]
                probs[src] = 0.0
                alive[src] = False
    keep = alive & (is_eog | (probs >= thold))
    if not (keep & ~is_eog).any():
        eogs = [int(c) for c in cand[is_eog]] or sorted(eog_ids)
        return int(eogs[0]) if eogs else int(cand[0])
    return draw(cand[keep], probs[keep])


def dry_penalties(tokens: list[int], vocab_size: int, multiplier: float = 0.0,
                  base: float = 1.75, allowed_length: int = 2,
                  penalty_last_n: int = 1024) -> Optional[dict[int, float]]:
    """DRY (llama_sampler_dry semantics, host side): each token z that would
    extend a repeat of the recent suffix is penalized by
    multiplier * base^(match_len - allowed_length)."""
    if multiplier <= 0.0 or len(tokens) < allowed_length:
        return None
    window = tokens[-penalty_last_n:]
    n = len(window)
    penalties: dict[int, float] = {}
    for i in range(n - 1):
        m = 0
        while m < i + 1 and m < n - 1 and window[i - m] == window[n - 1 - m]:
            m += 1
        if m >= allowed_length:
            z = window[i + 1]
            pen = multiplier * (base ** (m - allowed_length))
            penalties[z] = max(penalties.get(z, 0.0), pen)
    return penalties or None


def sample(logits: torch.Tensor, gen: torch.Generator, p: SamplerParams,
           recent_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply the sampler chain to logits [B, V] and draw one token per row,
    on the generator's device. Returns int64 [B] on the CPU."""
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
    probs = torch.softmax(logits, dim=-1).to(gen.device)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].cpu()


# ---------------------------------------------------------------------------
# On-device twins for the serving decode run ([B, V] logits, per-lane params)
# ---------------------------------------------------------------------------

Gens = Sequence[Optional[torch.Generator]]


def _lane_draws(gens: Gens, n: int, device, kind: str) -> torch.Tensor:
    """[B, n] f32 draws, each lane from its own generator: uniform [0, 1) or
    standard Gumbel (-log of an Exp(1) draw); zeros for a lane without one."""
    rows = []
    for g in gens:
        if g is None:
            rows.append(torch.zeros((n,), dtype=torch.float32, device=device))
        elif kind == "uniform":
            rows.append(torch.rand((n,), generator=g, device=device))
        else:
            rows.append(-torch.empty((n,), dtype=torch.float32, device=device)
                        .exponential_(generator=g).log())
    return torch.stack(rows)


def device_penalties(logits, counts, rep, frq, prs, bias) -> torch.Tensor:
    """Per-lane repetition/frequency/presence penalties plus a dense logit
    bias (apply_penalties' batched twin). logits, counts, bias [B, V] f32;
    rep, frq, prs [B]. Lanes at rep=1, frq=prs=0 with a zero bias row pass
    through unchanged."""
    present = counts > 0
    r = rep[:, None]
    pen = torch.where(logits > 0, logits / r, logits * r)
    logits = torch.where(present, pen, logits)
    logits = logits - counts * frq[:, None] - present.to(logits.dtype) * prs[:, None]
    return logits + bias


def device_xtc(logits, gens: Gens, temp, xtc_p, xtc_t) -> torch.Tensor:
    """Per-lane XTC (apply_xtc's batched twin): with probability xtc_p drop
    every token whose temperature-scaled prob reaches the threshold except
    the least likely of them. Lanes with xtc_p = 0 pass through."""
    t = torch.where(temp > 0, temp, torch.ones_like(temp))[:, None]
    probs = torch.softmax(logits / t, dim=-1)
    over = probs >= xtc_t[:, None]
    n_over = over.sum(-1, keepdim=True)
    min_over = torch.where(over, probs, torch.full_like(probs, float("inf"))).amin(
        -1, keepdim=True)
    drop = over & (probs > min_over) & (n_over >= 2)
    gate = _lane_draws(gens, 1, logits.device, "uniform")[:, 0] < xtc_p
    return torch.where(drop & gate[:, None], _neg_inf_like(logits), logits)


def device_mirostat(logits, gens: Gens, temp, mu, eta, tau):
    """Mirostat v2 on the device (mirostat_v2_sample's batched twin):
    truncate tokens whose surprise exceeds mu (the argmax always stays),
    sample by Gumbel-max, and move mu toward tau. Returns (token [B] int64,
    mu' [B])."""
    t = torch.where(temp > 0, temp, torch.ones_like(temp))[:, None]
    lp = torch.log_softmax(logits / t, dim=-1)
    surprise = -lp / math.log(2.0)
    keep = surprise <= mu[:, None]
    best = torch.argmax(lp, dim=-1)
    keep = keep | (torch.arange(lp.shape[-1], device=lp.device)[None, :] == best[:, None])
    masked = torch.where(keep, lp, torch.full_like(lp, NEG_INF))
    tok = torch.argmax(masked + _lane_draws(gens, lp.shape[-1], lp.device, "gumbel"), dim=-1)
    obs = torch.gather(surprise, 1, tok[:, None])[:, 0]
    return tok, mu - eta * (obs - tau)


def device_top_n_sigma(logits, nsig) -> torch.Tensor:
    """Per-lane top-n-sigma (apply_top_n_sigma's batched twin): mask logits
    below max - n * std, before the temperature (the cutoff scales with it).
    Lanes with nsig <= 0 pass through."""
    valid = logits > NEG_INF / 2
    cnt = valid.sum(-1, keepdim=True).clamp_min(1)
    zero = torch.zeros_like(logits)
    mean = torch.where(valid, logits, zero).sum(-1, keepdim=True) / cnt
    var = (torch.where(valid, logits - mean, zero) ** 2).sum(-1, keepdim=True) / cnt
    cutoff = torch.where(nsig[:, None] > 0,
                         logits.amax(-1, keepdim=True) - nsig[:, None] * var.sqrt(),
                         torch.full_like(var, NEG_INF))
    return torch.where(logits < cutoff, _neg_inf_like(logits), logits)


DRY_WINDOW = 256                    # device DRY ring length
DRY_MAX_MATCH = 32                  # capped match length (base^30 saturates f32)


def device_dry(dwin, cand_v, cand_i, mult, base, allowed_len, lastn):
    """DRY on the captured candidate rows (dry_penalties' device twin):
    dwin [B, W] recent tokens, newest last (-1 = empty); cand_v / cand_i
    [B, K] candidates in descending order. For each window position whose
    suffix match with the tail reaches allowed_len, the token after it is
    penalized by mult * base^(m - allowed_len); DRY only lowers logits, so
    the candidate set still holds every survivor. The rows are re-sorted.
    Returns (cand_v', cand_i')."""
    b, w = dwin.shape
    lmax = DRY_MAX_MATCH
    dev = dwin.device
    tail = dwin[:, (w - 1) - torch.arange(lmax, device=dev)]              # [B, L]
    ext = torch.cat([torch.full((b, lmax), -1, dtype=dwin.dtype, device=dev), dwin], dim=1)
    shifted = torch.stack([ext[:, lmax - j: lmax - j + w] for j in range(lmax)], dim=1)
    age = (w - 1) - torch.arange(w, device=dev)[None, :]
    ln = lastn.clamp_min(0)
    in_win = age < ln[:, None]                                              # [B, W]
    tail_in = torch.arange(lmax, device=dev)[None, :, None] < ln[:, None, None]
    eq = ((shifted == tail[:, :, None]) & (tail[:, :, None] >= 0) & (shifted >= 0)
          & in_win[:, None, :] & tail_in)                                   # [B, L, W]
    m = torch.cumprod(eq.to(torch.int32), dim=1).sum(dim=1)                 # [B, W]
    pen_i = torch.where(
        (m >= allowed_len.clamp_min(1)[:, None]) & (mult[:, None] > 0),
        mult[:, None] * torch.pow(base.clamp_min(1.0)[:, None],
                                  (m - allowed_len[:, None]).to(torch.float32)),
        torch.zeros((), dtype=torch.float32, device=dev))[:, :-1]           # [B, W-1]
    z = dwin[:, 1:]
    hit = (z[:, :, None] == cand_i[:, None, :]) & (z[:, :, None] >= 0)
    pen_c = torch.where(hit, pen_i[:, :, None], torch.zeros((), device=dev)).amax(dim=1)
    v2 = cand_v - pen_c
    order = torch.argsort(-v2, dim=-1, stable=True)
    return torch.gather(v2, -1, order), torch.gather(cand_i, -1, order)


def topk_candidates(logits, k_max: int = 128):
    """The k_max largest (vals, ids) of each row, in descending order, equal
    values in ascending id order as ``lax.top_k`` gives them (``torch.topk``
    leaves their order to the implementation, and a greedy pick over the
    candidates must be ``argmax``'s, the lowest id among ties): the shared
    pre-filter of device_sample and the decode run's per-step candidate
    capture. Exact (the TPU's approx_max_k is a TPU workaround)."""
    vals, ids = torch.topk(logits, k_max, dim=-1)
    ids, perm = ids.sort(dim=-1)
    vals, order = vals.gather(-1, perm).sort(dim=-1, descending=True, stable=True)
    return vals, ids.gather(-1, order)


def device_sample(logits, gens: Gens, temp, top_k, top_p, min_p, k_max: int = 128,
                  cands=None, typ_p=None) -> torch.Tensor:
    """Per-lane temperature / top-k / typical / top-p / min-p sampling over
    the k_max most likely candidates (the on-device chain after
    device_penalties). temp <= 0 takes the argmax; top_k [B] in [1, k_max];
    ``typ_p`` [B] turns the typical arm on (None: off, as when no lane asks
    for it). Draws are Gumbel-max, one generator per lane. Returns [B]
    int64."""
    vals, idx = cands if cands is not None else topk_candidates(logits, k_max)
    dev = vals.device
    rank = torch.arange(vals.shape[-1], device=dev)[None, :]
    allowed = rank < top_k.clamp_min(1)[:, None]
    t = torch.where(temp > 0, temp, torch.ones_like(temp))[:, None]
    ninf = torch.full_like(vals, float("-inf"))
    scaled = torch.where(allowed, vals / t, ninf)
    probs = torch.softmax(scaled, dim=-1)
    if typ_p is not None:
        pt = probs.clamp_min(1e-30)
        ent = -torch.where(allowed, probs * pt.log(), torch.zeros_like(probs)).sum(
            -1, keepdim=True)
        shifted = torch.where(allowed, (-pt.log() - ent).abs(),
                              torch.full_like(probs, float("inf")))
        order = torch.argsort(shifted, dim=-1, stable=True)
        p_sorted = torch.gather(probs, -1, order)
        keep_sorted = (torch.cumsum(p_sorted, dim=-1) - p_sorted) < typ_p[:, None]
        keep_typ = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
        allowed = allowed & keep_typ
        probs = torch.softmax(torch.where(allowed, scaled, ninf), dim=-1)
    keep_p = (torch.cumsum(probs, dim=-1) - probs) < top_p[:, None]
    keep_m = probs >= min_p[:, None] * probs.amax(dim=-1, keepdim=True)
    final = allowed & keep_p & keep_m
    if typ_p is None:
        final[:, 0] = True
    else:
        # typical may exclude rank 0; it comes back only if the set emptied
        final[:, 0] = final[:, 0] | ~final.any(-1)
    logp = torch.where(final, scaled, ninf)
    choice = torch.argmax(logp + _lane_draws(gens, vals.shape[-1], dev, "gumbel"), dim=-1)
    sampled = torch.gather(idx, 1, choice[:, None])[:, 0]
    return torch.where(temp <= 0, idx[:, 0], sampled)
