"""Pipeline (layer-split) parallelism over a mesh of pp stages.

Port of ``rrs_tpu/parallel/pipeline.py``. Each stage holds a contiguous
range of L / pp layers on its device (several stages may share one), and
microbatches flow through the stages on the GPipe schedule: n_micro + pp - 1
ticks, where at tick i stage s runs microbatch i - s and its output moves to
stage s + 1's device for the next tick. The JAX package runs the schedule as
one ``lax.scan`` under ``shard_map``, with ``ppermute`` between stages and a
``psum`` that broadcasts the last stage's outputs; here one host loop drives
the ticks (the launches of stages on distinct devices overlap, since nothing
waits for them), the embedding runs on the first stage's device and the
final norm and lm_head on the last's.

Scope: a prefill / evaluation forward (fresh per-call KV, causal within the
chunk). Each stage runs ``llama.layer``, the block of the single-device
forward, so every layer form it models (MoE, MLA, LongRoPE factors,
``residual_scale``) computes what ``llama.forward`` computes; the JAX
package's ``_one_layer`` models only plain pre-norm layers (ROADMAP queue
C). Sandwich-norm models (gemma2 / 3, olmo2's post norms) raise, as they do
in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from rrs_tpu_torch.models import llama as llama_model
from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.models.linear import linear_apply
from rrs_tpu_torch.ops.basic import rms_norm
from rrs_tpu_torch.parallel.sharding import _place


@dataclasses.dataclass
class PPMesh:
    """The pp stages' devices, in stage order."""

    devices: list

    @property
    def shape(self) -> dict:
        return {"pp": len(self.devices)}


def make_pp_mesh(n_devices: int = 0, devices=None, device=None) -> PPMesh:
    """pp stages over ``devices``, or over ``n_devices`` of ``device``'s kind:
    ``cuda:0 .. cuda:n-1`` (SystemExit when fewer are visible), or the CPU
    n times."""
    if devices is None:
        from rrs_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        if dev.type == "cpu":
            devices = [dev] * max(n_devices, 1)
        else:
            visible = torch.cuda.device_count()
            n = n_devices or visible
            if visible < n:
                raise SystemExit(f"--pp {n} needs {n} devices; only {visible} visible. "
                                 "For a CPU dry run pass --device cpu.")
            devices = [torch.device("cuda", i) for i in range(n)]
    return PPMesh(devices=[torch.device(d) for d in devices])


def stack_layers(layers: list) -> list:
    """The layers of each stage would stack on a leading axis in the JAX
    package (``jax.tree.map(jnp.stack)``), which needs homogeneous layers;
    the port keeps a list and checks the same: every layer has the fields
    of the first, at the same shapes."""
    def sig(obj):
        if isinstance(obj, torch.Tensor):
            return (tuple(obj.shape), obj.dtype)
        if dataclasses.is_dataclass(obj):
            return tuple((f.name, sig(getattr(obj, f.name))) for f in dataclasses.fields(obj))
        if isinstance(obj, (list, tuple)):
            return tuple(sig(o) for o in obj)
        return obj

    first = sig(layers[0])
    for li, lw in enumerate(layers[1:], 1):
        if sig(lw) != first:
            raise ValueError(f"layer {li} differs from layer 0: the pp stages need "
                             "homogeneous layers")
    return list(layers)


def make_pipeline_forward(cfg: ModelConfig, weights, mesh: PPMesh, b: int, t: int,
                          n_micro: int = 2):
    """The pipelined prefill step over ``mesh``: run(tokens [B, T], positions
    [B, T]) -> [B, T, V] f32 logits on the last stage's device. B splits
    into n_micro microbatches and the layers into pp equal stages; each
    stage's layers (and LongRoPE factors) are placed on its device once,
    here."""
    pp = len(mesh.devices)
    n_l = cfg.n_layers
    if n_l % pp:
        raise ValueError(f"{n_l} layers do not split into pp={pp} stages")
    for lw in weights.layers:
        if lw.attn_post_norm is not None or lw.ffn_post_norm is not None:
            raise NotImplementedError("sandwich-norm models not supported by the pp schedule yet")
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    bm = b // n_micro
    per = n_l // pp
    layers = stack_layers(weights.layers)
    stages = [dataclasses.replace(weights, layers=_place(layers[s * per:(s + 1) * per], dev),
                                  rope_factors=_place(weights.rope_factors, dev))
              for s, dev in enumerate(mesh.devices)]
    first, last = mesh.devices[0], mesh.devices[-1]
    embed = _place(weights.embed, first)
    final_norm = _place(weights.final_norm, last)
    lm_head = _place(weights.lm_head, last)

    @torch.inference_mode()
    def run(tokens, positions) -> torch.Tensor:
        tokens = torch.as_tensor(tokens).to(first, torch.int64)
        positions = torch.as_tensor(positions).to(torch.int32)
        if tuple(tokens.shape) != (b, t):
            raise ValueError(f"tokens {tuple(tokens.shape)}: the step was built for {(b, t)}")
        x = llama_model.embed_rows(embed, tokens)
        if cfg.embd_scale != 1.0:
            x = (x.to(torch.float32) * cfg.embd_scale).to(x.dtype)
        xm = x.reshape(n_micro, bm, t, x.shape[-1])
        pm = positions.reshape(n_micro, bm, t)
        outs = [None] * n_micro
        buf = [None] * pp                    # what enters each stage at this tick
        for tick in range(n_micro + pp - 1):
            nxt = [None] * pp
            for s in range(pp):
                m = tick - s
                if not 0 <= m < n_micro:
                    continue
                dev = mesh.devices[s]
                h = (xm[m] if s == 0 else buf[s]).to(dev)
                pos = pm[m].to(dev)
                ks, vs = llama_model.scratch_caches(cfg, bm, t, device=dev)
                slots = pm[m][:, 0].tolist()
                for i, lw in enumerate(stages[s].layers):
                    li = s * per + i
                    h = llama_model.layer(cfg, stages[s], lw, h, pos, ks[li], vs[li], pos,
                                          slots, li)
                if s == pp - 1:
                    outs[m] = h
                else:
                    nxt[s + 1] = h
            buf = nxt
        h = rms_norm(torch.cat([o.to(last) for o in outs], dim=0), final_norm, cfg.rms_eps)
        logits = linear_apply(lm_head, h).to(torch.float32)
        if cfg.logits_divisor != 1.0:
            logits = logits / cfg.logits_divisor
        if cfg.final_softcap > 0:
            logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
        return logits

    return run
