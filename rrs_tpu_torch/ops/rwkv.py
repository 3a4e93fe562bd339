"""RWKV6 linear attention (wkv6): plain PyTorch.

Port of ``rrs_tpu/ops/rwkv.py`` (``wkv6``, ``wkv6_ref``), plain jnp there
and no TPU kernel. Per head, with state S[i, j] (i = key dim, j = value
dim):

    out[t, j] = sum_i r[t, i] * (S[i, j] + tf[i] * k[t, i] * v[t, j])
    S[i, j]  <- td[t, i] * S[i, j] + k[t, i] * v[t, j]

where td is already exp(-exp(w)). The bonus ``tf`` reads the state before
the update, so the recurrence is not associative in this form; prefill is a
loop over T (``lax.scan`` in JAX) on an f32 state, and decode is its single
step.
"""

from __future__ import annotations

import numpy as np
import torch


def wkv6(k: torch.Tensor, v: torch.Tensor, r: torch.Tensor, tf: torch.Tensor,
         td: torch.Tensor, state: torch.Tensor):
    """k, v, r, td [B, T, H, D]; tf [H, D]; state [B, H, D, D] f32. Returns
    (out [B, T, H, D] f32, the new state [B, H, D, D] f32)."""
    kf, vf, rf, tdf = (a.to(torch.float32) for a in (k, v, r, td))
    bonus_w = tf.to(torch.float32)[None, :, :, None]
    s = state.to(torch.float32)
    outs = []
    for t in range(kf.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]          # [B, H, D, D]
        outs.append(torch.einsum("bhi,bhij->bhj", rf[:, t], s + bonus_w * kv))
        s = tdf[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s


def wkv6_ref(k, v, r, tf, td, state):
    """Sequential float64 NumPy oracle (the CPU ggml_rwkv_wkv6 loop)."""
    k, v, r, tf, td = (np.asarray(a, np.float64) for a in (k, v, r, tf, td))
    s = np.array(state, np.float64)
    b, t, h, d = k.shape
    out = np.zeros((b, t, h, d))
    for bb in range(b):
        for tt in range(t):
            for hh in range(h):
                for i in range(d):
                    kv = k[bb, tt, hh, i] * v[bb, tt, hh]
                    out[bb, tt, hh] += r[bb, tt, hh, i] * (s[bb, hh, i] + tf[hh, i] * kv)
                    s[bb, hh, i] = td[bb, tt, hh, i] * s[bb, hh, i] + kv
    return out, s
