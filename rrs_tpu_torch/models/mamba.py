"""Mamba-1 architecture (mamba, mamba2 and falcon_mamba files): token
embedding -> N x {RMSNorm -> mamba block} -> RMSNorm -> head.

Port of ``rrs_tpu/models/mamba.py``. A mamba block:

    xz = in_proj(h); x, z = split(xz)
    x  = silu(depthwise_conv1d(x, conv_state))
    dt, B, C = split(x_proj(x))             (RMS-normed: see below)
    dt = dt_proj(dt) + dt_bias
    y, h' = selective_scan(ssm_state, x, dt, A, B, C)
    y  = y + x * D
    out = out_proj(silu(z) * y)

Every projection goes through ``linear_apply`` (the TCQ4 / Q8 kernels, or a
dense matmul); the conv and the scan are plain torch (``ops/ssm.py``).

dt / B / C are RMS-normed with the layer's ``ssm_dt_norm`` / ``ssm_b_norm`` /
``ssm_c_norm`` weights where it has them (jamba), as in the JAX package.
Where it has none and the config sets ``ssm_dt_b_c_rms`` (falcon-mamba's
``ssm.dt_b_c_rms``), they take the weightless RMS norm of the published
model (Hugging Face ``FalconMambaMixer``, llama.cpp's mamba graph); the JAX
package reads the flag and never applies it (ROADMAP queue C).

The recurrent memory is (conv_state [d_conv - 1, d_inner] in the cache
dtype, ssm_state [d_inner, d_state] f32) per layer per lane; the context
lives in ``runtime/recurrent.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.models.linear import DenseLinear, TCQ4Linear, linear_apply, want_i8p
from rrs_tpu_torch.ops.basic import rms_norm
from rrs_tpu_torch.ops.ssm import ssm_conv, ssm_scan


@dataclasses.dataclass
class MambaLayer:
    norm: torch.Tensor
    w_in: Any                       # E -> 2 * d_inner
    conv_w: torch.Tensor            # [d_conv, d_inner] f32
    conv_b: torch.Tensor            # [d_inner] f32
    w_x: Any                        # d_inner -> dt_rank + 2 * d_state
    w_dt: Any                       # dt_rank -> d_inner
    dt_bias: torch.Tensor           # [d_inner] f32
    A: torch.Tensor                 # [d_inner, d_state] f32, negative
    D: torch.Tensor                 # [d_inner] f32
    w_out: Any                      # d_inner -> E
    dt_norm: Optional[torch.Tensor] = None
    b_norm: Optional[torch.Tensor] = None
    c_norm: Optional[torch.Tensor] = None


@dataclasses.dataclass
class MambaWeights:
    embed: torch.Tensor
    layers: list
    final_norm: torch.Tensor
    lm_head: Any

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


def mamba_block(cfg: ModelConfig, lw: MambaLayer, h: torch.Tensor, conv_state: torch.Tensor,
                ssm_state: torch.Tensor):
    """One mixer over h [B, T, E] (already normed) and a lane batch's
    states. Returns (out [B, T, E], new conv state, new ssm state)."""
    di, ds, dtr = cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_dt_rank
    xz = linear_apply(lw.w_in, h)
    x, z = xz[..., :di], xz[..., di:]
    x_conv, new_conv = ssm_conv(x, conv_state, lw.conv_w, lw.conv_b)
    x = torch.nn.functional.silu(x_conv).to(h.dtype)               # [B, T, di]
    x_db = linear_apply(lw.w_x, x)
    dt, bc, cc = x_db[..., :dtr], x_db[..., dtr:dtr + ds], x_db[..., dtr + ds:]
    if lw.dt_norm is not None or cfg.ssm_dt_b_c_rms:
        dt = rms_norm(dt, lw.dt_norm, cfg.rms_eps)
        bc = rms_norm(bc, lw.b_norm, cfg.rms_eps)
        cc = rms_norm(cc, lw.c_norm, cfg.rms_eps)
    dt = linear_apply(lw.w_dt, dt) + lw.dt_bias.to(torch.float32)
    y, new_ssm = ssm_scan(ssm_state, x, dt, lw.A, bc, cc)
    y = y + x.to(torch.float32) * lw.D.to(torch.float32)
    y = (torch.nn.functional.silu(z.to(torch.float32)) * y).to(h.dtype)
    return linear_apply(lw.w_out, y), new_conv, new_ssm


def keep_inactive(new: torch.Tensor, old: torch.Tensor, active) -> torch.Tensor:
    """The new state on active lanes, the old one elsewhere."""
    if active is None:
        return new
    return torch.where(active.reshape(-1, *([1] * (new.dim() - 1))), new, old.to(new.dtype))


def forward(cfg: ModelConfig, w: MambaWeights, tokens: torch.Tensor, conv_states: list,
            ssm_states: list, active: Optional[torch.Tensor] = None):
    """tokens [B, T] -> (logits [B, T, V] f32, new conv states, new ssm
    states); an inactive lane (``active`` [B] bool) keeps its states."""
    x = w.embed[tokens.clamp_min(0)]
    new_conv, new_ssm = [], []
    for li, lw in enumerate(w.layers):
        h = rms_norm(x, lw.norm, cfg.rms_eps)
        out, nc, ns = mamba_block(cfg, lw, h, conv_states[li], ssm_states[li])
        new_conv.append(keep_inactive(nc, conv_states[li], active))
        new_ssm.append(keep_inactive(ns, ssm_states[li], active))
        x = x + out
    x = rms_norm(x, w.final_norm, cfg.rms_eps)
    return linear_apply(w.lm_head, x).to(torch.float32), new_conv, new_ssm


# ---------------------------------------------------------------------------
# Weight builders
# ---------------------------------------------------------------------------

def random_layer(cfg: ModelConfig, rng: np.random.Generator, lin, tens, ones,
                 norms: bool = False) -> MambaLayer:
    """One MambaLayer in the draw order of the JAX ``random_weights``;
    ``norms`` adds unit dt / B / C norms (the JAX hybrid's layers)."""
    e, di, ds, dtr, dc = (cfg.n_embd, cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_dt_rank,
                          cfg.ssm_d_conv)
    f32 = torch.float32
    return MambaLayer(
        norm=ones(e), w_in=lin(e, 2 * di),
        conv_w=tens(rng.standard_normal((dc, di)) * 0.2, f32),
        conv_b=tens(np.zeros((di,)), f32),
        w_x=lin(di, dtr + 2 * ds), w_dt=lin(dtr, di, 0.1),
        dt_bias=tens(rng.standard_normal((di,)) * 0.1, f32),
        A=tens(-np.exp(rng.standard_normal((di, ds)) * 0.5), f32),
        D=tens(np.ones((di,)), f32), w_out=lin(di, e),
        dt_norm=ones(dtr) if norms else None, b_norm=ones(ds) if norms else None,
        c_norm=ones(ds) if norms else None)


def random_weights(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                   device="cpu") -> MambaWeights:
    """Random dense weights from a NumPy generator, in the draw order of the
    JAX ``random_weights`` (so one seed gives both packages the same
    weights); tied head."""
    rng = np.random.default_rng(seed)

    def tens(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device=device, dtype=dt)

    def lin(k, n, scale=0.02):
        return DenseLinear(w=tens(rng.standard_normal((k, n)) * scale))

    ones = lambda n: torch.ones((n,), dtype=dtype, device=device)   # noqa: E731
    layers = [random_layer(cfg, rng, lin, tens, ones) for _ in range(cfg.n_layers)]
    embed = tens(rng.standard_normal((cfg.vocab_size, cfg.n_embd)) * 0.02)
    return MambaWeights(embed=embed, layers=layers, final_norm=ones(cfg.n_embd),
                        lm_head=DenseLinear(w=embed.t()))


class Fabricator:
    """Weights drawn on a device from a seeded ``torch.Generator``: linears
    TCQ4 (uniform qs bytes, bf16 eff in [0.001, 0.011), each with its i8p
    pack unless ``RRS_PREFILL_I8=0``) where K % 256 == 0 and N % 8 == 0, as
    the quantizer picks them, else bf16 N(0, 0.02); ``quantized=False``
    draws every linear bf16 N(0, ``dense_scale``). Also the Q8_0 head (padded
    by ``n_pad_width``), normals and uniforms."""

    def __init__(self, seed: int, device, quantized: bool = True, dense_scale: float = 0.05):
        from rrs_tpu_torch.device import resolve_device

        self.dev = resolve_device(device)
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(seed)
        self.quantized = quantized
        self.dense_scale = dense_scale
        self.packed = want_i8p()

    def normal(self, scale, shape, dtype=torch.bfloat16) -> torch.Tensor:
        return (torch.randn(shape, generator=self.gen, device=self.dev) * scale).to(dtype)

    def uniform(self, lo, hi, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.dev) * (hi - lo) + lo

    def ones(self, n, dtype=torch.bfloat16) -> torch.Tensor:
        return torch.ones((n,), dtype=dtype, device=self.dev)

    def lin(self, k: int, n: int):
        from rrs_tpu_torch.ops.tcq4_matmul import pack_i8p

        if not self.quantized or k % 256 or n % 8:
            return DenseLinear(w=self.normal(self.dense_scale if not self.quantized else 0.02,
                                             (k, n)))
        qs = torch.randint(0, 256, (k // 2, n), generator=self.gen, device=self.dev,
                           dtype=torch.uint8)
        eff = self.uniform(0.001, 0.011, (k // 32, n)).to(torch.bfloat16)
        return TCQ4Linear(qs=qs, eff=eff, i8p=pack_i8p(qs, eff) if self.packed else None)

    def head(self, e: int, vocab: int):
        from rrs_tpu_torch.models.linear import Q8Linear, n_pad_width

        if not self.quantized:
            return DenseLinear(w=self.normal(self.dense_scale, (e, vocab)))
        n_pad = n_pad_width(vocab)
        q = torch.randint(-127, 128, (e, n_pad), generator=self.gen, device=self.dev,
                          dtype=torch.int8)
        return Q8Linear(q=q, scale=self.uniform(0.0, 1e-3, (e // 32, n_pad)), n_logical=vocab)

    def mamba_layer(self, cfg: ModelConfig, norms: bool = False) -> MambaLayer:
        """A MambaLayer: conv taps N(0, 0.2), dt bias N(0, 0.1), A =
        -exp(N(0, 0.5)), D ones, the norms N(1, 0.2) (with unit dt / B / C
        norms where ``norms``)."""
        e, di, ds, dtr, dc = (cfg.n_embd, cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_dt_rank,
                              cfg.ssm_d_conv)
        f32 = torch.float32
        return MambaLayer(
            norm=(1.0 + self.normal(0.2, (e,), f32)).to(torch.bfloat16),
            w_in=self.lin(e, 2 * di), conv_w=self.normal(0.2, (dc, di), f32),
            conv_b=self.normal(0.02, (di,), f32), w_x=self.lin(di, dtr + 2 * ds),
            w_dt=self.lin(dtr, di), dt_bias=self.normal(0.1, (di,), f32),
            A=-torch.exp(self.normal(0.5, (di, ds), f32)), D=self.ones(di, f32),
            w_out=self.lin(di, e),
            dt_norm=self.ones(dtr) if norms else None, b_norm=self.ones(ds) if norms else None,
            c_norm=self.ones(ds) if norms else None)


def fabricated_tcq4_weights(cfg: ModelConfig, seed: int = 0, device=None,
                            quantized: bool = True) -> MambaWeights:
    """Mamba weights drawn on the device (``Fabricator``): each projection
    TCQ4 where the quantizer would make it so (Falcon-Mamba-7B: ssm_in,
    ssm_x at N = 288, ssm_dt at K = 256 and ssm_out), a bf16 embedding
    N(0, 0.02) and an untied Q8_0 head; ``quantized=False`` draws bf16
    linears and head (the card-vs-CPU glue checks). For runs where the
    compute and the traffic matter and the values do not."""
    fab = Fabricator(seed, device, quantized)
    layers = [fab.mamba_layer(cfg) for _ in range(cfg.n_layers)]
    return MambaWeights(embed=fab.normal(0.02, (cfg.vocab_size, cfg.n_embd)), layers=layers,
                        final_norm=fab.ones(cfg.n_embd), lm_head=fab.head(cfg.n_embd,
                                                                           cfg.vocab_size))


_LAYER_LINEARS = ("w_in", "w_x", "w_dt", "w_out")


def layer_from_numpy(ld: dict, dev) -> MambaLayer:
    from rrs_tpu_torch.models.llama import _linear_from_numpy, _tensor

    return MambaLayer(**{k: (_linear_from_numpy(v, dev) if k in _LAYER_LINEARS
                             else _tensor(v, dev)) for k, v in ld.items()})


def weights_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> MambaWeights:
    """The port's weights from the JAX MambaWeights given as a nested dict
    of NumPy arrays keyed by its field names (``embed``, ``final_norm``,
    ``lm_head`` and ``layers[i]`` with the MambaLayer fields, each linear a
    dict as ``llama.weights_from_numpy`` takes it)."""
    from rrs_tpu_torch.device import resolve_device
    from rrs_tpu_torch.models.llama import _linear_from_numpy, _tensor

    dev = resolve_device(device)
    return MambaWeights(embed=_tensor(tree["embed"], dev),
                        layers=[layer_from_numpy(ld, dev) for ld in tree["layers"]],
                        final_norm=_tensor(tree["final_norm"], dev),
                        lm_head=_linear_from_numpy(tree["lm_head"], dev))
