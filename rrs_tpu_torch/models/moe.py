"""Mixture-of-Experts FFN over MXFP4 expert stacks (gpt-oss).

Port of ``rrs_tpu/models/moe.py``: ``MoEWeights``, the router ``route``
(softmax or sigmoid gating with the post-top-k norm, the selection bias, expert
groups, and gpt-oss's top-k on the raw logits plus router bias then a softmax
over the k), the ``swiglu_oai`` activation, the capacity dispatch, and the
MXFP4 branches of ``moe_ffn``, chosen by token count as there:

  <= 16 tokens  the selected experts' rows (B12, ``mxfp4_matmul_experts_rows``);
  <= 64 tokens  every expert over the shared activations (B13), combined with
                the routing weights;
  more          capacity dispatch: each expert's routed tokens padded to a
                capacity C, one per-expert B13 launch per projection, and the
                exact per-expert scan over all tokens (B11) when routing
                overflows C.

The two decode-sized branches read nothing back to the host, so a device
decode run stays free of syncs; the capacity branch reads the largest expert
count once per layer to choose between its two paths (JAX decides with a
``lax.cond`` on the device). TCQ4 expert stacks (kernels B9 / B10), dense bf16
expert stacks and shared experts raise NotImplementedError: they are the next
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.ops.mxfp4_matmul import (_round_up, mxfp4_matmul, mxfp4_matmul_all_experts,
                                            mxfp4_matmul_experts_rows)

NEXT_SLICE = "TCQ4 and dense expert stacks (kernels B9 / B10) are the next slice of rrs_tpu_torch"


@dataclasses.dataclass
class MoEWeights:
    """One MoE layer: the router [E_in, n_experts] (x @ router) and the
    packed expert stacks ``*_qs`` uint8 [E, K//2, Npad] / ``*_eff`` uint8
    [E, K//32, Npad] (the field names of the JAX package, which keeps TCQ4
    scales there too), with gate / up [E, n_embd -> n_ff_exp] and down
    [E, n_ff_exp -> n_embd]."""

    router: torch.Tensor
    gate_qs: Optional[torch.Tensor] = None
    gate_eff: Optional[torch.Tensor] = None
    up_qs: Optional[torch.Tensor] = None
    up_eff: Optional[torch.Tensor] = None
    down_qs: Optional[torch.Tensor] = None
    down_eff: Optional[torch.Tensor] = None
    # DeepSeek-V3 selection bias [n_experts]: added for top-k only
    probs_bias: Optional[torch.Tensor] = None
    # gpt-oss router bias [n_experts] and per-expert biases [E, F] / [E, K]
    router_bias: Optional[torch.Tensor] = None
    gate_b: Optional[torch.Tensor] = None
    up_b: Optional[torch.Tensor] = None
    down_b: Optional[torch.Tensor] = None
    quant_kind: str = "mxfp4"


def route(cfg: ModelConfig, mw: MoEWeights, x2: torch.Tensor):
    """Router: (expert ids [T, k] int64, weights [T, k] f32)."""
    logits = x2.to(torch.float32) @ mw.router.to(torch.float32)
    if mw.router_bias is not None:
        logits = logits + mw.router_bias.to(torch.float32)
    if cfg.expert_softmax_weight:
        probs = logits
    elif cfg.expert_gating_softmax:
        probs = torch.softmax(logits, dim=-1)
    else:
        probs = torch.sigmoid(logits)
    sel = probs
    if mw.probs_bias is not None:
        sel = probs + mw.probs_bias.to(torch.float32)
    if cfg.n_expert_groups > 1:
        t, e = sel.shape
        ng = cfg.n_expert_groups
        grouped = sel.reshape(t, ng, e // ng)
        gscore = torch.topk(grouped, 2, dim=-1).values.sum(-1)            # [T, G]
        gidx = torch.topk(gscore, max(cfg.n_group_used, 1), dim=-1).indices
        gmask = torch.zeros((t, ng), dtype=torch.bool, device=sel.device).scatter(1, gidx, True)
        sel = torch.where(gmask[:, :, None], grouped,
                          torch.full_like(grouped, -float("inf"))).reshape(t, e)
    topi = torch.topk(sel, cfg.n_experts_used, dim=-1).indices
    topv = torch.gather(probs, 1, topi)                                    # unbiased weights
    if cfg.expert_softmax_weight:
        topv = torch.softmax(topv, dim=-1)
    elif cfg.norm_topk_prob or cfg.expert_weights_norm:
        topv = topv / topv.sum(-1, keepdim=True).clamp_min(6.1035156e-5)
    if cfg.expert_weights_scale != 1.0:
        topv = topv * cfg.expert_weights_scale
    return topi, topv


def _moe_act(cfg: ModelConfig, g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """swiglu_oai (gpt-oss): gate clamped above at 7, up to [-7, 7], then
    x * sigmoid(1.702 x) * (y + 1); else silu(g) * u. f32 in, f32 out."""
    if cfg.moe_act == "swiglu_oai":
        x = g.clamp_max(7.0)
        y = u.clamp(-7.0, 7.0)
        return x * torch.sigmoid(1.702 * x) * (y + 1.0)
    return torch.nn.functional.silu(g) * u


def _combine(topi, topv, n_exp: int) -> torch.Tensor:
    """Routing weights as a dense [T, E] matrix (0 off the selected k)."""
    return torch.zeros((topi.shape[0], n_exp), dtype=torch.float32,
                       device=topv.device).scatter(1, topi, topv)


def _capacity_dispatch(n_exp: int, kk: int, n_tok: int, a, topi, topv, run_experts,
                       fallback):
    """Sort the token slots by expert, pad each expert's group to a capacity
    C, run ``run_experts(buf [E, C, K]) -> [E, C, D]`` once and sum each
    token's weighted rows. When an expert draws more than C slots (the one
    host readback of this path) the exact ``fallback()`` runs instead."""
    n_sel = n_tok * kk
    cap = min(_round_up(n_tok, 8), max(64, _round_up(2 * n_sel // n_exp, 64)))
    ids_flat = topi.reshape(-1)
    counts = torch.zeros((n_exp,), dtype=torch.int64, device=a.device).scatter_add_(
        0, ids_flat, torch.ones_like(ids_flat))
    if cap < n_tok and int(counts.max()) > cap:
        return fallback()
    order = torch.argsort(ids_flat, stable=True)
    sorted_ids = ids_flat[order]
    first = torch.cumsum(counts, 0) - counts                      # exclusive prefix
    # each selection's row in the [E * C] buffer, in token-major order
    slot = torch.empty_like(order)
    slot[order] = sorted_ids * cap + torch.arange(n_sel, device=a.device) - first[sorted_ids]
    buf = torch.zeros((n_exp * cap, a.shape[-1]), dtype=a.dtype, device=a.device)
    buf[slot] = a.repeat_interleave(kk, dim=0)
    d = run_experts(buf.reshape(n_exp, cap, a.shape[-1]))          # [E, C, D]
    # a fixed-order sum over each token's k rows (a scatter-add's atomics
    # would sum them in another order on every run)
    vals = d.reshape(n_exp * cap, d.shape[-1])[slot]
    return (vals.reshape(n_tok, kk, -1) * topv[..., None]).sum(1)


def moe_ffn(cfg: ModelConfig, mw: MoEWeights, x: torch.Tensor) -> torch.Tensor:
    """x [B, T, E] -> [B, T, E] in x's dtype."""
    if mw.quant_kind != "mxfp4" or mw.gate_qs is None:
        raise NotImplementedError(NEXT_SLICE)
    b, t, e = x.shape
    x2 = x.reshape(b * t, e)
    topi, topv = route(cfg, mw, x2)
    n_tok = b * t
    fe = cfg.n_ff_exp
    kk = cfg.n_experts_used
    n_exp = mw.gate_qs.shape[0]
    a = x2.to(torch.bfloat16)                    # MXFP4 is weights-only: bf16 activations
    if n_tok <= 16:
        # decode: only the selected experts' tiles are read (B12)
        ids = topi.reshape(-1)
        ar = a.repeat_interleave(kk, dim=0)
        g = mxfp4_matmul_experts_rows(ar, mw.gate_qs, mw.gate_eff, ids)[:, :fe]
        u = mxfp4_matmul_experts_rows(ar, mw.up_qs, mw.up_eff, ids)[:, :fe]
        if mw.gate_b is not None:
            g = g + mw.gate_b[ids]
            u = u + mw.up_b[ids]
        a2 = _moe_act(cfg, g, u).to(torch.bfloat16)
        d = mxfp4_matmul_experts_rows(a2, mw.down_qs, mw.down_eff, ids)[:, :e]
        out = (d.reshape(n_tok, kk, e) * topv[..., None]).sum(1)
    elif n_tok <= 64:
        # batched decode: every expert once over the shared activations (B13)
        g = mxfp4_matmul_all_experts(a, mw.gate_qs, mw.gate_eff)[..., :fe]
        u = mxfp4_matmul_all_experts(a, mw.up_qs, mw.up_eff)[..., :fe]
        if mw.gate_b is not None:
            g = g + mw.gate_b[:, None, :]
            u = u + mw.up_b[:, None, :]
        a2 = _moe_act(cfg, g, u).to(torch.bfloat16)                   # [E, T, F]
        d = mxfp4_matmul_all_experts(a2, mw.down_qs, mw.down_eff)[..., :e]
        out = torch.einsum("etk,te->tk", d, _combine(topi, topv, n_exp))
    else:
        zeros = torch.zeros((n_exp, fe), dtype=torch.float32, device=x.device)
        gb = mw.gate_b if mw.gate_b is not None else zeros
        ub = mw.up_b if mw.up_b is not None else zeros

        def run_experts(buf):                                         # [E, C, K] (B13)
            g = mxfp4_matmul_all_experts(buf, mw.gate_qs, mw.gate_eff)[..., :fe] + gb[:, None]
            u = mxfp4_matmul_all_experts(buf, mw.up_qs, mw.up_eff)[..., :fe] + ub[:, None]
            a2 = _moe_act(cfg, g, u).to(torch.bfloat16)
            return mxfp4_matmul_all_experts(a2, mw.down_qs, mw.down_eff)[..., :e]

        def scan_fallback():                                          # every token, per expert (B11)
            combine = _combine(topi, topv, n_exp)
            acc = torch.zeros((n_tok, e), dtype=torch.float32, device=x.device)
            for ei in range(n_exp):
                g = mxfp4_matmul(a, mw.gate_qs[ei], mw.gate_eff[ei])[:, :fe] + gb[ei]
                u = mxfp4_matmul(a, mw.up_qs[ei], mw.up_eff[ei])[:, :fe] + ub[ei]
                a2 = _moe_act(cfg, g, u).to(torch.bfloat16)
                y = mxfp4_matmul(a2, mw.down_qs[ei], mw.down_eff[ei])[:, :e]
                acc = acc + y * combine[:, ei:ei + 1]
            return acc

        out = _capacity_dispatch(n_exp, kk, n_tok, a, topi, topv, run_experts, scan_fallback)
    if mw.down_b is not None:
        # the per-expert down bias, once after the combine, weighted by topv
        out = out + (mw.down_b[topi] * topv[..., None]).sum(1)
    return out.reshape(b, t, e).to(x.dtype)
