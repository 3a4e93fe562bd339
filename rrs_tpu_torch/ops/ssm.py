"""Selective state-space ops (Mamba-1): plain PyTorch.

Port of ``rrs_tpu/ops/ssm.py`` (``ssm_conv``, ``ssm_scan``, ``ssm_step``,
``ssm_scan_ref``). None of these is a TPU kernel: they are plain jnp there,
and the projections around them go through the linear kernels. The
recurrence

    h_t = exp(softplus(dt_t) * A) * h_{t-1} + softplus(dt_t) * B_t * x_t
    y_t = C_t . h_t

is a first-order linear scan. JAX runs prefill through
``jax.lax.associative_scan``; here ``ssm_scan`` is a log-step
(Hillis-Steele) scan over T in whole-tensor ops, ceil(log2 T) combine
steps, so that a 128-token chunk launches a few dozen kernels where a loop
over T would launch hundreds. The combine order differs from JAX's tree, so
the sums round differently (held within JAX's own tolerances).
``softplus`` is ``logaddexp(x, 0)``, JAX's definition.

Shapes (batch-major):
    x   [B, T, D]        D = d_inner
    dt  [B, T, D]        pre-softplus
    A   [D, N]           N = d_state (negative)
    Bc  [B, T, N]
    Cc  [B, T, N]
    h0  [B, D, N]        f32 carried state
"""

from __future__ import annotations

import numpy as np
import torch


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, x.new_zeros(()))


def ssm_conv(x: torch.Tensor, conv_state: torch.Tensor, weight: torch.Tensor,
             bias: torch.Tensor):
    """Depthwise causal 1-D conv over the token axis: x [B, T, D], the
    carried conv_state [B, d_conv - 1, D], weight [d_conv, D], bias [D].
    Returns (y [B, T, D] f32, the new state: the last d_conv - 1 columns,
    in conv_state's dtype)."""
    d_conv = weight.shape[0]
    t = x.shape[1]
    ctx = torch.cat([conv_state.to(x.dtype), x], dim=1)          # [B, K - 1 + T, D]
    y = ctx[:, 0:t].to(torch.float32) * weight[0].to(torch.float32)
    for k in range(1, d_conv):                                   # d_conv is 4: unrolled
        y = y + ctx[:, k:k + t].to(torch.float32) * weight[k].to(torch.float32)
    y = y + bias.to(torch.float32)
    return y, ctx[:, ctx.shape[1] - (d_conv - 1):].to(conv_state.dtype)


def ssm_scan(h0: torch.Tensor, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bc: torch.Tensor, Cc: torch.Tensor):
    """The selective scan over T (log-step). Returns (y [B, T, D] f32,
    h_T [B, D, N] f32)."""
    dtp = _softplus(dt.to(torch.float32))                        # [B, T, D]
    a = torch.exp(dtp[..., None] * A.to(torch.float32))          # [B, T, D, N]
    b = (dtp * x.to(torch.float32))[..., None] * Bc.to(torch.float32)[:, :, None, :]
    t = a.shape[1]
    d = 1
    while d < t:
        # prefix (a1, b1) ending at t - d, then segment (a2, b2) at t:
        # (a2 a1, a2 b1 + b2)
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    h = torch.addcmul(b, a, h0.to(torch.float32)[:, None])       # [B, T, D, N]
    y = torch.einsum("btdn,btn->btd", h, Cc.to(torch.float32))
    return y, h[:, -1]


def ssm_step(h0: torch.Tensor, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bc: torch.Tensor, Cc: torch.Tensor):
    """One token (decode): x, dt [B, D], Bc, Cc [B, N]. Returns (y [B, D]
    f32, h1 [B, D, N] f32)."""
    dtp = _softplus(dt.to(torch.float32))
    decay = torch.exp(dtp[..., None] * A.to(torch.float32)[None])
    h1 = decay * h0 + (dtp * x.to(torch.float32))[..., None] \
        * Bc.to(torch.float32)[:, None, :]
    y = torch.einsum("bdn,bn->bd", h1, Cc.to(torch.float32))
    return y, h1


def ssm_scan_ref(h0, x, dt, A, Bc, Cc):
    """Sequential float64 NumPy oracle with the same semantics."""
    h = np.asarray(h0, np.float64)
    xf = np.asarray(x, np.float64)
    dtf = np.log1p(np.exp(np.asarray(dt, np.float64)))
    Af = np.asarray(A, np.float64)
    Bf = np.asarray(Bc, np.float64)
    Cf = np.asarray(Cc, np.float64)
    ys = []
    for i in range(xf.shape[1]):
        decay = np.exp(dtf[:, i][..., None] * Af[None])
        h = decay * h + (dtf[:, i] * xf[:, i])[..., None] * Bf[:, i][:, None, :]
        ys.append(np.einsum("bdn,bn->bd", h, Cf[:, i]))
    return np.stack(ys, 1), h
