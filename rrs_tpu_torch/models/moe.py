"""Mixture-of-Experts FFN over packed (MXFP4, TCQ4) or dense bf16 expert
stacks.

Port of ``rrs_tpu/models/moe.py``: ``MoEWeights``, ``quantize_experts``, the
router ``route`` (softmax or sigmoid gating with the post-top-k norm, the
selection bias, expert groups, and gpt-oss's top-k on the raw logits plus
router bias then a softmax over the k), the ``swiglu_oai`` activation, the
capacity dispatch, every branch of ``moe_ffn``, chosen by token count as
there, and qwen2moe's dense SwiGLU shared expert, added to the routed output
with no gate, as in the JAX package.

Packed stacks: MXFP4 (gpt-oss) is weights-only, with bf16 activations; TCQ4
(qwen3moe) is W4A4, its activations RRS-rotated and int4 quantize-dequantized
(``_rotate_quant``) before each projection.

  <= 16 tokens  the selected experts' rows (B12 ``mxfp4_matmul_experts_rows``,
                B9 ``tcq4_matmul_experts_rows``);
  <= 64 tokens  MXFP4 only: every expert over the shared activations (B13),
                combined with the routing weights;
  more          capacity dispatch: each expert's routed tokens padded to a
                capacity C, one per-expert all-experts launch per projection
                (B13, B10), and the exact per-expert scan over all tokens
                when routing overflows C (B11, or a TCQ4 expert dequantized
                by ``_dequant_expert`` and a plain matmul).

Packed stacks refuse autograd (NotImplementedError): ``jax.grad`` fails in
every branch of the JAX ``moe_ffn`` over them. Dense stacks are plain torch
and differentiate as JAX's do.

Dense stacks take a gather of the selected experts' weights at <= 16 tokens,
and otherwise the capacity dispatch with the all-experts einsum as its exact
fallback; their products are plain f32 matmuls of the bf16 values, as in the
JAX package, where no Pallas kernel computes them.

The decode-sized branches read nothing back to the host, so a device decode
run stays free of syncs; the capacity branch reads the largest expert count
once per layer, and only when C can overflow (JAX decides with a
``lax.cond`` on the device).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rrs_tpu_torch import kernels
from rrs_tpu_torch.formats.tcq4 import (dequantize_activations_rrs, effective_scales,
                                        quantize_activations_rrs, quantize_tcq4)
from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.models.linear import _dense_matmul, rotate_activations
from rrs_tpu_torch.ops.mxfp4_matmul import (_round_up, mxfp4_matmul, mxfp4_matmul_all_experts,
                                            mxfp4_matmul_experts_rows)
from rrs_tpu_torch.ops.tcq4_matmul import tcq4_matmul_all_experts, tcq4_matmul_experts_rows

@dataclasses.dataclass
class MoEWeights:
    """One MoE layer: the router [E_in, n_experts] (x @ router), and either
    dense bf16 stacks ``gate`` / ``up`` [E, n_embd, n_ff_exp] and ``down``
    [E, n_ff_exp, n_embd], or packed stacks ``*_qs`` uint8 [E, K//2, N] with
    ``*_eff`` (TCQ4: bf16 [E, K//32, N] group scales; MXFP4: uint8 exponents,
    N possibly padded), the field names of the JAX package; qwen2moe adds a
    dense shared expert ``shared_gate`` / ``shared_up`` [n_embd, F_sh] and
    ``shared_down`` [F_sh, n_embd] (bf16, x @ w)."""

    router: torch.Tensor
    gate: Optional[torch.Tensor] = None
    up: Optional[torch.Tensor] = None
    down: Optional[torch.Tensor] = None
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
    shared_gate: Optional[torch.Tensor] = None
    shared_up: Optional[torch.Tensor] = None
    shared_down: Optional[torch.Tensor] = None
    quant_kind: str = "tcq4"          # codec of the packed stacks: "tcq4" | "mxfp4"

    @property
    def quantized(self) -> bool:
        return self.gate_qs is not None


def quantize_experts(mw: MoEWeights) -> MoEWeights:
    """Dense bf16 stacks -> TCQ4 stacks on the host (the load-time per-expert
    analog of ``TCQ4Linear.from_tensor``), bit-equal to the JAX
    ``quantize_experts``. Both matmul dims must be multiples of 256."""
    def quant_stack(w):
        qs_l, eff_l = [], []
        for e in range(w.shape[0]):
            t = quantize_tcq4(w[e].float().cpu().numpy().T)
            qs_l.append(t.qs)
            eff_l.append(effective_scales(t).astype(np.float32))
        return (torch.from_numpy(np.stack(qs_l)).to(w.device),
                torch.from_numpy(np.stack(eff_l)).to(torch.bfloat16).to(w.device))

    gate_qs, gate_eff = quant_stack(mw.gate)
    up_qs, up_eff = quant_stack(mw.up)
    down_qs, down_eff = quant_stack(mw.down)
    return dataclasses.replace(mw, gate=None, up=None, down=None, gate_qs=gate_qs,
                               gate_eff=gate_eff, up_qs=up_qs, up_eff=up_eff, down_qs=down_qs,
                               down_eff=down_eff, quant_kind="tcq4")


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


def _dequant_expert(qs: torch.Tensor, eff: torch.Tensor) -> torch.Tensor:
    """[..., K//2, F] uint8 + eff [..., K//32, F] -> [..., K, F] bf16, the
    int4 times the f32 group scale rounded once. Within each 256-K superblock
    the low nibbles hold k in [0, 128) and the high nibbles [128, 256)."""
    *lead, k2, f = qs.shape
    q = qs.to(torch.int32).reshape(*lead, k2 // 128, 128, f)
    w_q = torch.cat([(q << 28) >> 28, (q << 24) >> 28], dim=-2).reshape(*lead, 2 * k2, f)
    return (w_q.to(torch.float32)
            * eff.to(torch.float32).repeat_interleave(32, dim=-2)).to(torch.bfloat16)


def _rotate_quant(x2: torch.Tensor) -> torch.Tensor:
    """RRS rotation, then the int4 quantize-dequantize of each 256-block: the
    bf16 activations of a TCQ4 expert projection."""
    a_q, a_s = quantize_activations_rrs(rotate_activations(x2, None))
    return dequantize_activations_rrs(a_q, a_s).to(torch.bfloat16)


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


def capacity(n_exp: int, kk: int, n_tok: int) -> int:
    """The capacity dispatch's rows an expert (C) for n_tok tokens of k
    selections each over n_exp experts."""
    return min(_round_up(n_tok, 8), max(64, _round_up(2 * n_tok * kk // n_exp, 64)))


def _capacity_dispatch(n_exp: int, kk: int, n_tok: int, a, topi, topv, run_experts,
                       fallback, n_global: int = 0):
    """Sort the token slots by expert, pad each expert's group to a capacity
    C, run ``run_experts(buf [E, C, K]) -> [E, C, D]`` once and sum each
    token's weighted rows. When an expert draws more than C slots (the one
    host readback of this path, made only where C < n_tok) the exact
    ``fallback()`` runs instead. ``n_global`` > 0 (an expert-parallel shard
    holding ``n_exp`` of ``n_global`` experts): C is the whole stack's, and
    id ``n_exp`` marks another shard's expert, whose slots (weight 0) share
    one spare buffer row that no expert reads."""
    n_sel = n_tok * kk
    cap = capacity(n_global or n_exp, kk, n_tok)
    ids_flat = topi.reshape(-1)
    counts = torch.zeros((n_exp + bool(n_global),), dtype=torch.int64,
                         device=a.device).scatter_add_(0, ids_flat, torch.ones_like(ids_flat))
    if cap < n_tok and int(counts[:n_exp].max()) > cap:
        return fallback()
    order = torch.argsort(ids_flat, stable=True)
    sorted_ids = ids_flat[order]
    first = torch.cumsum(counts, 0) - counts                      # exclusive prefix
    # each selection's row in the [E * C] buffer, in token-major order
    slot = torch.empty_like(order)
    slot[order] = sorted_ids * cap + torch.arange(n_sel, device=a.device) - first[sorted_ids]
    if n_global:
        slot = slot.clamp_max(n_exp * cap)
    buf = torch.zeros((n_exp * cap + bool(n_global), a.shape[-1]), dtype=a.dtype,
                      device=a.device)
    buf[slot] = a.repeat_interleave(kk, dim=0)
    d = run_experts(buf[:n_exp * cap].reshape(n_exp, cap, a.shape[-1]))     # [E, C, D]
    d = d.reshape(n_exp * cap, d.shape[-1])
    if n_global:
        d = torch.cat([d, d.new_zeros((1, d.shape[-1]))])
    # a fixed-order sum over each token's k rows (a scatter-add's atomics
    # would sum them in another order on every run)
    vals = d[slot]
    return (vals.reshape(n_tok, kk, -1) * topv[..., None]).sum(1)


def _local_experts(cfg: ModelConfig, topi, topv):
    """An expert-parallel shard's view of the routing (``cfg.ep_axis``): the
    selections of its experts get their local ids and keep their weights;
    the others get id ``count`` and weight 0. Returns (ids, weights, count,
    first)."""
    ep = cfg.ep_axis
    ids = topi - ep.first
    own = (ids >= 0) & (ids < ep.count)
    return (torch.where(own, ids, torch.full_like(ids, ep.count)),
            torch.where(own, topv, torch.zeros_like(topv)), ep.count, ep.first)


def _packed_ffn(cfg: ModelConfig, mw: MoEWeights, x2: torch.Tensor, topi, topv) -> torch.Tensor:
    """The MXFP4 and TCQ4 branches: f32 [T, n_embd]."""
    n_tok, e = x2.shape
    # a jamba file carries no expert_feed_forward_length: its experts are
    # n_ff wide (the JAX package slices them to 0 there; ROADMAP queue C)
    fe, kk = cfg.n_ff_exp or cfg.n_ff, cfg.n_experts_used
    n_exp = mw.gate_qs.shape[0]
    mx = mw.quant_kind == "mxfp4"
    if mx:
        rows_mm, all_mm = mxfp4_matmul_experts_rows, mxfp4_matmul_all_experts
        prep = lambda v: v.to(torch.bfloat16)                        # noqa: E731
    else:
        rows_mm, all_mm, prep = tcq4_matmul_experts_rows, tcq4_matmul_all_experts, _rotate_quant
    a = prep(x2)                                                     # [T, K] bf16
    if n_tok <= 16:
        # decode: only the selected experts' tiles are read (B12, B9)
        ids = topi.reshape(-1)
        ar = a.repeat_interleave(kk, dim=0)
        g = rows_mm(ar, mw.gate_qs, mw.gate_eff, ids)[:, :fe]
        u = rows_mm(ar, mw.up_qs, mw.up_eff, ids)[:, :fe]
        if mw.gate_b is not None:
            g = g + mw.gate_b[ids]
            u = u + mw.up_b[ids]
        a2 = prep(_moe_act(cfg, g, u))
        d = rows_mm(a2, mw.down_qs, mw.down_eff, ids)[:, :e]
        return (d.reshape(n_tok, kk, e) * topv[..., None]).sum(1)
    if mx and n_tok <= 64:
        # batched decode: every expert once over the shared activations (B13)
        g = mxfp4_matmul_all_experts(a, mw.gate_qs, mw.gate_eff)[..., :fe]
        u = mxfp4_matmul_all_experts(a, mw.up_qs, mw.up_eff)[..., :fe]
        if mw.gate_b is not None:
            g = g + mw.gate_b[:, None, :]
            u = u + mw.up_b[:, None, :]
        a2 = prep(_moe_act(cfg, g, u))                                  # [E, T, F]
        d = mxfp4_matmul_all_experts(a2, mw.down_qs, mw.down_eff)[..., :e]
        return torch.einsum("etk,te->tk", d, _combine(topi, topv, n_exp))
    zeros = torch.zeros((n_exp, fe), dtype=torch.float32, device=x2.device)
    gb = mw.gate_b if mw.gate_b is not None else zeros
    ub = mw.up_b if mw.up_b is not None else zeros

    def run_experts(buf):                                             # [E, C, K] (B13, B10)
        g = all_mm(buf, mw.gate_qs, mw.gate_eff)[..., :fe] + gb[:, None]
        u = all_mm(buf, mw.up_qs, mw.up_eff)[..., :fe] + ub[:, None]
        act = _moe_act(cfg, g, u)                                     # [E, C, F]
        a2 = prep(act.reshape(-1, act.shape[-1])).reshape(act.shape)
        return all_mm(a2, mw.down_qs, mw.down_eff)[..., :e]

    def mm(act, qs, eff):
        if mx:
            return mxfp4_matmul(act, qs, eff)                          # B11
        return act.to(torch.float32) @ _dequant_expert(qs, eff).to(torch.float32)

    def scan_fallback():                                              # every token, per expert
        combine = _combine(topi, topv, n_exp)
        acc = torch.zeros((n_tok, e), dtype=torch.float32, device=x2.device)
        for ei in range(n_exp):
            g = mm(a, mw.gate_qs[ei], mw.gate_eff[ei])[:, :fe] + gb[ei]
            u = mm(a, mw.up_qs[ei], mw.up_eff[ei])[:, :fe] + ub[ei]
            a2 = prep(_moe_act(cfg, g, u))
            y = mm(a2, mw.down_qs[ei], mw.down_eff[ei])[:, :e]
            acc = acc + y * combine[:, ei:ei + 1]
        return acc

    return _capacity_dispatch(n_exp, kk, n_tok, a, topi, topv, run_experts, scan_fallback)


def _dense_ffn(cfg: ModelConfig, mw: MoEWeights, x2: torch.Tensor, topi, topv,
               dtype) -> torch.Tensor:
    """The dense bf16 branches: f32 [T, n_embd]. The activation between the
    two products is rounded to the layer's dtype, as in the JAX package."""
    n_tok = x2.shape[0]
    f32 = lambda t: t.to(torch.float32)                              # noqa: E731
    x32 = f32(x2)
    routes = (topi, topv)                                            # over the whole stack
    n_global, lo = 0, 0
    if cfg.ep_axis is not None:
        # an expert-parallel shard: its experts only, the others weighted 0
        n_global = cfg.n_experts
        topi, topv, _, lo = _local_experts(cfg, topi, topv)
    if n_tok <= 16:
        # gather: the selected experts' weights per token (another shard's
        # expert reads the last local one, weighted 0)
        ids = topi if cfg.ep_axis is None else topi.clamp_max(mw.gate.shape[0] - 1)
        g = torch.einsum("tk,tekf->tef", x32, f32(mw.gate[ids]))
        u = torch.einsum("tk,tekf->tef", x32, f32(mw.up[ids]))
        if mw.gate_b is not None:
            g = g + mw.gate_b[ids]
            u = u + mw.up_b[ids]
        act = f32(_moe_act(cfg, g, u).to(dtype))                      # [T, k, F]
        out = torch.einsum("tef,tefk->tek", act, f32(mw.down[ids]))
        return (out * topv[..., None]).sum(1)
    n_exp = mw.gate.shape[0]

    def run_experts(buf):                                             # [E, C, K]
        g = torch.einsum("eck,ekf->ecf", f32(buf), f32(mw.gate))
        u = torch.einsum("eck,ekf->ecf", f32(buf), f32(mw.up))
        if mw.gate_b is not None:
            g = g + mw.gate_b[:, None, :]
            u = u + mw.up_b[:, None, :]
        act = f32(_moe_act(cfg, g, u).to(dtype))
        return torch.einsum("ecf,efk->eck", act, f32(mw.down))

    def dense_fallback():                                             # every expert, every token
        g = torch.einsum("tk,ekf->tef", x32, f32(mw.gate))
        u = torch.einsum("tk,ekf->tef", x32, f32(mw.up))
        if mw.gate_b is not None:
            g = g + mw.gate_b[None]
            u = u + mw.up_b[None]
        act = f32(_moe_act(cfg, g, u).to(dtype))                      # [T, E, F]
        y = torch.einsum("tef,efk->tek", act, f32(mw.down))
        combine = _combine(*routes, cfg.n_experts)[:, lo:lo + mw.gate.shape[0]]
        return torch.einsum("tek,te->tk", y, combine)

    return _capacity_dispatch(n_exp, cfg.n_experts_used, n_tok, x2, topi, topv, run_experts,
                              dense_fallback, n_global=n_global)


def moe_ffn(cfg: ModelConfig, mw: MoEWeights, x: Optional[torch.Tensor]) -> torch.Tensor:
    """x [B, T, E] -> [B, T, E] in x's dtype. On a shard of a training mesh
    with ep > 1 (``cfg.ep_axis``) every ep rank takes ep rank 0's x (the
    others pass None: they run only their experts)."""
    if cfg.ep_axis is not None:
        x = cfg.ep_axis.share(x)
    if mw.quantized and mw.quant_kind not in ("mxfp4", "tcq4"):
        raise NotImplementedError(f"expert stacks of kind {mw.quant_kind!r}")
    if mw.quantized and kernels.needs_grad(x, mw.router):
        raise NotImplementedError(
            f"the backward of packed {mw.quant_kind} expert stacks: JAX's jax.grad fails in "
            "every branch of its moe_ffn there (its expert kernels have no VJP); train with "
            "dense expert stacks")
    if mw.quantized and cfg.ep_axis is not None:
        raise NotImplementedError("packed expert stacks split over ep: their kernels take the "
                                  "whole stack (train with dense expert stacks)")
    b, t, e = x.shape
    x2 = x.reshape(b * t, e)
    topi, topv = route(cfg, mw, x2)
    if mw.quantized:
        out = _packed_ffn(cfg, mw, x2, topi, topv)
    else:
        out = _dense_ffn(cfg, mw, x2, topi, topv, x.dtype)
    reduce_axis = cfg.ep_axis or cfg.tp_axis
    if reduce_axis is not None and not mw.quantized:
        # dense stacks split on F over tp (and on E over ep): the routed
        # output is a partial sum
        out = reduce_axis.all_reduce(out)
    if mw.down_b is not None:
        # the per-expert down bias, once after the combine, weighted by topv
        if cfg.ep_axis is None:
            out = out + (mw.down_b[topi] * topv[..., None]).sum(1)
        else:
            # the bias rows split over ep: each ep rank's share (from its tp
            # rank 0 only), summed over the group, then added
            ids, wts, n_loc, _ = _local_experts(cfg, topi, topv)
            part = (mw.down_b[ids.clamp_max(n_loc - 1)] * wts[..., None]).sum(1)
            if cfg.tp_axis is not None and cfg.tp_axis.rank:
                part = torch.zeros_like(part)
            out = out + cfg.ep_axis.all_reduce(part)
    if mw.shared_gate is not None and not (cfg.ep_axis is not None and cfg.ep_axis.ep_rank):
        # the shared expert, on every token, added with no gate (under ep,
        # by ep rank 0 alone: the other ranks' output goes unread)
        g = _dense_matmul(x2, mw.shared_gate)
        u = _dense_matmul(x2, mw.shared_up)
        act = (torch.nn.functional.silu(g) * u).to(x.dtype)
        shared = _dense_matmul(act, mw.shared_down)
        if cfg.tp_axis is not None:
            shared = cfg.tp_axis.all_reduce(shared)
        out = out + shared
    return out.reshape(b, t, e).to(x.dtype)
