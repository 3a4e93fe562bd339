"""rrs_tpu_torch/parallel/train_step.py against the JAX package's SPMD train
step (tests/test_train_sharding.py) on the conftest's 8 virtual CPU devices,
the port on 8 CPU shards of the same (dp, ep, tp) meshes.

Tolerances (each case states its own):
* losses: 1e-4 absolute against JAX's sharded step and ``_loss_fn`` on one
  device (JAX's own test allows 1e-3); the TCQ4 model's first loss 1e-3,
  tests/test_torch_train.py's limit for W4A4 losses, where an int4 code may flip on a last-bit
  difference, and its second 5 % of the loss JAX's step took off;
* gradients of the f32 models: each leaf's joined gradient within relative
  L2 1e-5 of ``jax.grad`` of the single-device loss (measured worst 3.9e-6:
  the f32 sums of a row-parallel product in another order);
* parameters after two SGD steps: each leaf joined within relative L2 1e-5
  of JAX's sharded step's;
* the capacity branches at T = 64: test_torch_train.py's GRAD_TOL against jax.grad (max
  5e-3 of the leaf's largest, L2 2e-3). The gradient reaching the K / V
  rows is rounded to bf16 on its way in both packages, and at 64 positions
  some of those roundings flip on a last-bit difference: the port's own
  single-device step is 1.3e-4 from jax.grad there, the mesh 2.2e-4;
* gpt-oss's expert biases over ep: BIAS_GRAD_TOL against jax.grad (max 1e-2
  of the leaf's largest, L2 5e-3; measured worst 2.8e-3 and 2.0e-3, where
  the port's one device is 4.4e-5 from jax.grad: the bf16 roundings of the
  K rows' gradient, as in the capacity branches);
* the repeat test: bit for bit;
* the TCQ4 model's gradients against the port's own single-device step over
  each dp row: max 3e-2 of the leaf's largest, L2 2e-2 (measured worst
  1.2e-2 and 9.6e-3, the embedding and the norms). Its leaves and
  activations are bf16, and the gradient of a replicated activation reaches
  each tp shard as a part, rounded to bf16 and summed in bf16 where one
  device rounds the whole once (test_torch_train.py's BF16_GRAD_TOL, 2e-2 and 5e-3, holds
  one device against JAX).
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.models.config import ModelConfig as JaxConfig
from rrs_tpu.models.export import export_random_gguf
from rrs_tpu.models.loader import load_model as jax_load_model
from rrs_tpu.parallel import train_step as jts
from rrs_tpu.train import finetune as jft
from rrs_tpu_torch.models.loader import load_model
from rrs_tpu_torch.parallel import train_step as ts
from rrs_tpu_torch.train import finetune as tft

from test_torch_common import exact_jit, torch_cfg, weights_tree
from test_torch_train import GRAD_TOL, _flat

ROOT = Path(__file__).resolve().parent.parent
LOSS_TOL = 1e-4
TCQ4_LOSS_TOL = 1e-3
TCQ4_LR = 0.5
TCQ4_DROP_TOL = 0.05
MESH_BF16_GRAD_TOL = (3e-2, 2e-2)
BIAS_GRAD_TOL = (1e-2, 5e-3)
GRAD_REL = 1e-5
PARAM_REL = 1e-5

MOE = dict(arch="qwen3moe", n_layers=2, n_embd=64, n_heads=4, n_kv_heads=2, head_dim=16, n_ff=0,
           vocab_size=64, context_length=64, qk_norm=True, n_experts=4, n_experts_used=2,
           n_ff_exp=64, norm_topk_prob=True)
DENSE = dict(arch="qwen3", n_layers=2, n_embd=64, n_heads=4, n_kv_heads=2, head_dim=16,
             n_ff=128, vocab_size=64, context_length=64, qk_norm=True)
# tests/test_torch_multihost.py's widths: every row-parallel K stays 256-aligned
TCQ4 = dict(arch="qwen3", n_layers=2, n_embd=256, n_heads=8, n_kv_heads=4, head_dim=128,
            n_ff=1024, vocab_size=512, context_length=128, qk_norm=True)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """JAX's two test models (tests/test_train_sharding.py), f32 and unfused,
    loaded by each package: {name: (jax cfg, jax weights, port cfg, port
    weights)}."""
    d = tmp_path_factory.mktemp("train_sharding")
    out = {}
    for name, kw, seed in (("moe", MOE, 3), ("dense", DENSE, 4)):
        export_random_gguf(JaxConfig(**kw), d / f"{name}.gguf", seed=seed)
        jcfg, jw = jax_load_model(d / f"{name}.gguf", dtype=np.float32, fuse=False)[:2]
        tcfg, tw = load_model(d / f"{name}.gguf", dtype=torch.float32, fuse=False,
                              device="cpu")[:2]
        out[name] = (jcfg, jw, tcfg, tw)
    return out


def _jax_grad(jcfg, jw, batch):
    params, static = jft.partition(jw)
    return jax.value_and_grad(
        lambda p: jft._loss_fn(jcfg, jft.combine(p, static), jnp.asarray(batch)))(params)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _jax_steps(jcfg, jw, mesh_kw, batch, tc, n=2, n_devices=8):
    """JAX's sharded step, n times, compiled without XLA's excess precision
    (``exact_jit``: its bf16 casts, the K / V scratch caches' among them,
    round as the op-by-op forward's and the port's do): (losses, the
    parameters after, the mesh, the parameters after the first step)."""
    with exact_jit():
        mesh = jts.make_train_mesh(n_devices, **mesh_kw)
        step, params, _, opt_state = jts.make_sharded_train_step(jcfg, mesh, jw, tc)
        b = jts.shard_batch(batch, mesh)
        losses, first = [], None
        for i in range(n):
            params, opt_state, loss = step(params, opt_state, b)
            losses.append(float(loss))
            first = params if i == 0 else first
    return losses, params, mesh, first


def _port_steps(tcfg, tw, mesh_kw, batch, tc, n=2, n_devices=8):
    """The port's sharded step on ``n_devices`` CPU shards, n times:
    (losses, the first step's joined gradients, the joined parameters after,
    the parameters, the joined parameters after the first step)."""
    mesh = ts.make_train_mesh(devices=["cpu"] * n_devices, **mesh_kw)
    step, params, _, opt_state = ts.make_sharded_train_step(tcfg, mesh, tw, tc)
    losses, grads, first = [], None, None
    b = ts.shard_batch(batch, mesh)
    for i in range(n):
        params, opt_state, loss = step(params, opt_state, b)
        losses.append(float(loss))
        if i == 0:
            grads, first = params.joined_grads(), params.joined()
    return losses, grads, params.joined(), params, first


def _hold_grads(port_grads, jax_grads, tol):
    fp, fj = _flat(port_grads), _flat(jax_grads)
    assert set(fp) == set(fj) and len(fj) > 10
    worst = max((_rel(fp[k], fj[k]), k) for k in fj)
    assert worst[0] <= tol, worst
    return worst


def _hold_params(port_after, jax_after, tol):
    fp, fj = _flat(port_after), _flat(jax_after)
    assert set(fp) == set(fj)
    worst = max((_rel(fp[k], fj[k]), k) for k in fj)
    assert worst[0] <= tol, worst
    return worst


def test_moe_step_matches_jax(models):
    """(a) JAX's qwen3moe case: dense f32 expert stacks over dp 2 x ep 2 x tp
    2, batch (2, 17). Each shard's expert gate is JAX's addressable shard for
    its (dp, ep, tp) index, bit for bit; the first loss is JAX's sharded and
    single-device loss; the second is lower; every leaf's joined gradient is
    jax.grad's; after two SGD steps every leaf's update is JAX's sharded
    step's."""
    jcfg, jw, tcfg, tw = models["moe"]
    batch = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 17), dtype=np.int32)
    tc = tft.TrainConfig(optimizer="sgd", lr=0.1)
    mesh_kw = dict(dp=2, ep=2)
    jl, jp, jmesh, _ = _jax_steps(jcfg, jw, mesh_kw, batch,
                                  jft.TrainConfig(optimizer="sgd", lr=0.1))
    losses, grads, after, params, _ = _port_steps(tcfg, tw, mesh_kw, batch, tc)
    assert params.weights.mesh.shape == {"dp": 2, "ep": 2, "tp": 2}
    # the expert stacks' slices are JAX's shards
    sharded = ts.shard_train_weights(tw, params.weights.mesh)
    jgate = jts.shard_train_weights(jw, jmesh).layers[0].moe.gate
    assert jgate.sharding.spec == jax.sharding.PartitionSpec("ep", None, "tp")
    for sh in jgate.addressable_shards:
        d, e, r = (int(i) for i in np.argwhere(jmesh.devices == sh.device)[0])
        ours = sharded.shards[(d, e, r)].layers[0].moe.gate
        np.testing.assert_array_equal(ours.numpy(), np.asarray(sh.data))
    ref_loss, ref_grads = _jax_grad(jcfg, jw, batch)
    assert abs(losses[0] - jl[0]) <= LOSS_TOL and abs(losses[0] - float(ref_loss)) <= LOSS_TOL
    assert losses[1] < losses[0] and abs(losses[1] - jl[1]) <= LOSS_TOL, (losses, jl)
    _hold_grads(grads, ref_grads, GRAD_REL)
    _hold_params(after, jp, PARAM_REL)


def test_moe_capacity_branch_over_ep(models):
    """The dense experts' capacity dispatch (64 tokens a row) and its
    all-experts fallback (a capacity forced below the busiest expert's
    count) with the stacks over ep 2 x tp 2 and ep 4: the loss and every
    joined gradient against jax.grad on one device."""
    from rrs_tpu_torch.models import moe

    jcfg, jw, tcfg, tw = models["moe"]
    batch = np.random.default_rng(5).integers(0, jcfg.vocab_size, (1, 65), dtype=np.int32)
    ref_loss, ref_grads = _jax_grad(jcfg, jw, batch)
    orig = moe.capacity
    for cap in (None, 8):
        moe.capacity = orig if cap is None else (lambda n_exp, kk, n_tok: cap)
        try:
            for ep in (2, 4):
                mesh = ts.make_train_mesh(devices=["cpu"] * 4, ep=ep)
                step, params, _, opt = ts.make_sharded_train_step(
                    tcfg, mesh, tw, tft.TrainConfig(optimizer="sgd", lr=0.0))
                _, _, loss = step(params, opt, batch)
                assert abs(float(loss) - float(ref_loss)) <= LOSS_TOL
                fp, fj = _flat(params.joined_grads()), _flat(ref_grads)
                for k, ref in fj.items():
                    err = np.abs(fp[k] - ref).max() / max(np.abs(ref).max(), 1e-30)
                    assert err <= GRAD_TOL[0] and _rel(fp[k], ref) <= GRAD_TOL[1], (k, err)
        finally:
            moe.capacity = orig


def _hold_to_jax_grad(tcfg, tw, meshes, batch, ref_loss, ref_grads, tol):
    """One SGD step at lr 0 on each mesh (``make_train_mesh`` keywords): the
    loss within LOSS_TOL of ``ref_loss`` and each joined gradient within
    ``tol`` (max of the leaf's largest, rel L2) of ``ref_grads``."""
    ref = _flat(ref_grads)
    for kw in meshes:
        mesh = ts.make_train_mesh(**kw)
        step, params, _, opt = ts.make_sharded_train_step(
            tcfg, mesh, tw, tft.TrainConfig(optimizer="sgd", lr=0.0))
        _, _, loss = step(params, opt, batch)
        assert abs(float(loss) - float(ref_loss)) <= LOSS_TOL, (mesh.shape, float(loss))
        got = _flat(params.joined_grads())
        assert set(got) == set(ref)
        for k, g in ref.items():
            err = np.abs(got[k] - g).max() / max(np.abs(g).max(), 1e-30)
            assert err <= tol[0] and _rel(got[k], g) <= tol[1], (mesh.shape, k, err)


def test_expert_biases_over_ep(tmp_path):
    """gpt-oss's dense f32 expert stacks with their biases (tiny-oss: the
    router bias, sinks, sliding layers, swiglu_oai) over ep 2 x tp 2 and ep
    4: ``gate_b`` / ``up_b`` cut on E (and F), ``down_b`` on E and added
    once after the routed sum, as JAX's plan shards them. Both packages
    load the file: the loss within LOSS_TOL of jax.grad's single-device
    loss, each joined gradient within BIAS_GRAD_TOL of jax.grad's (max of
    the leaf's largest, rel L2; measured worst 2.8e-3 and 2.0e-3, wk and its
    bias, where the port's one device is 4.4e-5 and 1.7e-5 from jax.grad:
    the gradient reaching the K rows is rounded to bf16 by the scratch
    caches, and a last-bit change of the routed sum's order flips some of
    those roundings, as in the capacity test)."""
    from rrs_tpu.models.config import PRESETS as JPRESETS

    export_random_gguf(JPRESETS["tiny-oss"], tmp_path / "oss.gguf", seed=23)
    jcfg, jw = jax_load_model(tmp_path / "oss.gguf", dtype=np.float32, fuse=False)[:2]
    tcfg, tw = load_model(tmp_path / "oss.gguf", dtype=torch.float32, fuse=False,
                          device="cpu")[:2]
    mw = tw.layers[0].moe
    assert mw.gate is not None and mw.down_b is not None and tcfg.n_experts % 4 == 0
    batch = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 17), dtype=np.int32)
    ref_loss, ref_grads = _jax_grad(jcfg, jw, batch)
    _hold_to_jax_grad(tcfg, tw, [dict(devices=["cpu"] * 4, ep=2), dict(devices=["cpu"] * 4, ep=4)],
                      batch, ref_loss, ref_grads, BIAS_GRAD_TOL)


def test_shared_expert_over_ep(models):
    """A shared expert (qwen2moe's: on every token, ungated) beside the
    qwen3moe model's dense f32 stacks, in both packages' weights, over dp 2
    x ep 2 x tp 2 and ep 4: the shared expert is cut on its F over tp and
    run by ep rank 0 alone. The loss within LOSS_TOL and each joined
    gradient within GRAD_TOL of jax.grad's (measured worst rel L2 3.6e-6)."""
    jcfg, jw, tcfg, tw = models["moe"]
    rng = np.random.default_rng(9)
    jl, tl = [], []
    for jlw, tlw in zip(jw.layers, tw.layers):
        sh = {"shared_gate": rng.standard_normal((64, 128)) * 0.1,
              "shared_up": rng.standard_normal((64, 128)) * 0.1,
              "shared_down": rng.standard_normal((128, 64)) * 0.1}
        jl.append(dataclasses.replace(jlw, moe=dataclasses.replace(
            jlw.moe, **{k: jnp.asarray(v, jnp.float32) for k, v in sh.items()})))
        tl.append(dataclasses.replace(tlw, moe=dataclasses.replace(
            tlw.moe, **{k: torch.tensor(v, dtype=torch.float32) for k, v in sh.items()})))
    jw, tw = dataclasses.replace(jw, layers=jl), dataclasses.replace(tw, layers=tl)
    batch = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 17), dtype=np.int32)
    ref_loss, ref_grads = _jax_grad(jcfg, jw, batch)
    _hold_to_jax_grad(tcfg, tw, [dict(devices=["cpu"] * 8, dp=2, ep=2),
                                 dict(devices=["cpu"] * 4, ep=4)],
                      batch, ref_loss, ref_grads, GRAD_TOL)


@pytest.mark.parametrize("name,mesh_kw", [("dense", dict(dp=2, n=4)),
                                          ("moe", dict(dp=2, ep=2, n=8))],
                         ids=["dp2xtp2", "dp2xep2xtp2"])
def test_step_repeats_bit_for_bit(models, name, mesh_kw):
    """Three fresh meshes, two AdamW steps each, give the same losses, the
    same first-step gradients and the same parameters, bit for bit, though
    the calling thread made a different number of autograd nodes before
    each. The backward sums the parts of a replicated leaf's gradient (four
    or eight shards on one device) in the order of its nodes' sequence
    numbers, which each thread counts on its own: each shard runs on a
    thread of its own, a collective is recorded by its lowest rank's thread
    and the shards' losses are summed in one node."""
    _, _, tcfg, tw = models[name]
    kw = dict(mesh_kw)
    n = kw.pop("n")
    batch = np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 17), dtype=np.int32)
    runs = []
    for i in range(3):
        x = torch.ones(1, requires_grad=True)
        for _ in range(100 * i + 7):
            x = x * 1.0
        losses, grads, after, _, _ = _port_steps(tcfg, tw, kw, batch, tft.TrainConfig(lr=1e-2),
                                                 n_devices=n)
        runs.append((losses, _flat(grads), _flat(after)))
    for losses, grads, after in runs[1:]:
        assert losses == runs[0][0]
        for ref, got in ((runs[0][1], grads), (runs[0][2], after)):
            assert set(got) == set(ref)
            for k, v in ref.items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_dense_step_matches_jax(models):
    """(b) JAX's dense qwen3 case over dp 4 x tp 2 (ep 1): the losses of two
    AdamW steps against JAX's sharded step's, falling, the first against
    the single-device loss; the joined gradients against jax.grad."""
    jcfg, jw, tcfg, tw = models["dense"]
    batch = np.random.default_rng(1).integers(0, 64, (4, 9), dtype=np.int32)
    tc = tft.TrainConfig(lr=1e-2)
    jl, _, _, _ = _jax_steps(jcfg, jw, dict(dp=4, ep=1), batch, jft.TrainConfig(lr=1e-2))
    losses, grads, _, params, _ = _port_steps(tcfg, tw, dict(dp=4, ep=1), batch, tc)
    assert params.weights.mesh.shape == {"dp": 4, "tp": 2}
    ref_loss, ref_grads = _jax_grad(jcfg, jw, batch)
    assert all(np.isfinite(losses)) and losses[1] < losses[0]
    assert max(abs(a - b) for a, b in zip(losses, jl)) <= LOSS_TOL, (losses, jl)
    assert abs(losses[0] - float(ref_loss)) <= LOSS_TOL
    _hold_grads(grads, ref_grads, GRAD_REL)


def test_global_norm_clip_matches_jax(models):
    """(c) ``clip_norm`` at half the global gradient norm over dp 2 x ep 2 x
    tp 2: JAX's ``clip_by_global_norm`` over the whole model. Two SGD steps'
    losses are JAX's sharded step's; after the first, every leaf is JAX's
    and the update has the norm lr x clip: a norm over one shard's pieces,
    or with a replicated leaf counted once a shard, would scale it
    otherwise."""
    jcfg, jw, tcfg, tw = models["moe"]
    batch = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 17), dtype=np.int32)
    _, ref_grads = _jax_grad(jcfg, jw, batch)
    gnorm = float(np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                              for g in _flat(ref_grads).values())))
    clip, lr = gnorm / 2, 0.1
    jtc = jft.TrainConfig(optimizer="sgd", lr=lr, clip_norm=clip)
    tc = tft.TrainConfig(optimizer="sgd", lr=lr, clip_norm=clip)
    jl, _, _, jp = _jax_steps(jcfg, jw, dict(dp=2, ep=2), batch, jtc)
    losses, _, _, _, first = _port_steps(tcfg, tw, dict(dp=2, ep=2), batch, tc)
    assert max(abs(a - b) for a, b in zip(losses, jl)) <= LOSS_TOL, (losses, jl)
    _hold_params(first, jp, PARAM_REL)
    moved = np.sqrt(sum(np.sum((np.asarray(a, np.float64) - b) ** 2)
                        for a, b in zip(_flat(first).values(), _flat(tw).values())))
    assert abs(moved - lr * clip) <= 1e-4 * lr * clip, (moved, lr * clip)


@pytest.mark.parametrize("mesh_kw", [dict(dp=1, n=2), dict(dp=2, n=4)],
                         ids=["tp2", "dp2xtp2"])
def test_tcq4_step_matches_jax(mesh_kw):
    """(d) A TCQ4 qwen3 (E 256, 8 / 4 heads x 128, FF 1,024: every shard's
    row-parallel K 256-aligned) at tp = 2 and dp 2 x tp 2: two SGD steps'
    losses against JAX's sharded step on the same mesh, both falling; the
    straight-through gradients against the port's own single-device step
    (MESH_BF16_GRAD_TOL), TCQ4's scales getting none."""
    from rrs_tpu.models import llama as jllama
    from rrs_tpu_torch.models.llama import weights_from_numpy

    jcfg = JaxConfig(**TCQ4)
    jw = jllama.random_weights(jcfg, seed=7, quantize=True)
    tcfg = torch_cfg(jcfg)
    tw = weights_from_numpy(tcfg, weights_tree(jw), device="cpu")
    batch = np.random.default_rng(2).integers(0, 512, (2, 9), dtype=np.int32)
    n, dp = mesh_kw["n"], mesh_kw["dp"]
    jl, _, _, _ = _jax_steps(jcfg, jw, dict(dp=dp), batch,
                         jft.TrainConfig(optimizer="sgd", lr=TCQ4_LR), n_devices=n)
    mesh = ts.make_train_mesh(devices=["cpu"] * n, dp=dp)
    step, params, _, opt = ts.make_sharded_train_step(
        tcfg, mesh, tw, tft.TrainConfig(optimizer="sgd", lr=TCQ4_LR))
    losses = []
    for i in range(2):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
        if i == 0:
            grads = _flat(params.joined_grads())
    # the first loss at TCQ4_LOSS_TOL; after the step the int4 codes part on
    # last-bit differences of the updated weights (measured 1.1 % and 3.5 %
    # of JAX's drop), so the second loss is held to TCQ4_DROP_TOL of the drop
    assert losses[1] < losses[0] and jl[1] < jl[0], (losses, jl)
    assert abs(losses[0] - jl[0]) <= TCQ4_LOSS_TOL, (losses, jl)
    assert abs(losses[1] - jl[1]) <= TCQ4_DROP_TOL * (jl[0] - jl[1]), (losses, jl)
    # one device over each dp row's rows (the mesh's M, so the same kernel
    # routes: B1 at M = 8 a row), the rows' losses averaged
    sp, sst, _ = tft.trainable(tw)
    for rows in np.split(batch, dp):
        (tft._loss_fn(tcfg, tft.combine(sp, sst), rows) / dp).backward()
    single = _flat(tft._tree_map(
        lambda p: None if p is None else (torch.zeros_like(p) if p.grad is None else p.grad), sp))
    assert set(single) == set(grads)
    for k, ref in single.items():
        got = grads[k]
        if k.endswith("eff"):
            assert not got.any() and not ref.any(), k
            continue
        err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err <= MESH_BF16_GRAD_TOL[0] and _rel(got, ref) <= MESH_BF16_GRAD_TOL[1], (k, err)


def test_refusals(models):
    """(e) Fused projections are refused, as JAX's plan asserts; packed
    expert stacks and a TCQ4 linear with a channel permutation are refused
    under autograd (NotImplementedError), as the single-device step
    refuses them. The mesh's shape must split the shards."""
    from rrs_tpu.formats.tcq4 import quantize_tcq4
    from rrs_tpu.models import linear as jlin
    from rrs_tpu_torch.models import llama as tllama
    from rrs_tpu_torch.models.linear import TCQ4Linear, fuse_linears
    from rrs_tpu_torch.models.moe import quantize_experts

    jcfg, jw, tcfg, tw = models["dense"]
    assert tw.layers[0].wqkv is None
    fused = dataclasses.replace(tw, layers=[dataclasses.replace(
        tw.layers[0], wqkv=fuse_linears([tw.layers[0].wq, tw.layers[0].wk,
                                                tw.layers[0].wv]),
        wq=None, wk=None, wv=None)] + tw.layers[1:])
    with pytest.raises(ValueError, match="fused projections"):
        ts.make_sharded_train_step(tcfg, ts.make_train_mesh(devices=["cpu"] * 2), fused)
    jfused = dataclasses.replace(jw, layers=[dataclasses.replace(
        jw.layers[0], wqkv=jlin.fuse_linears([jw.layers[0].wq, jw.layers[0].wk,
                                              jw.layers[0].wv]),
        wq=None, wk=None, wv=None)] + list(jw.layers[1:]))
    with pytest.raises(AssertionError, match="fused projections"):
        jts.shard_train_weights(jfused, jts.make_train_mesh(2))
    with pytest.raises(ValueError, match="do not split"):
        ts.make_train_mesh(devices=["cpu"] * 6, dp=4)
    # packed TCQ4 expert stacks, at widths their codec takes, over ep 2
    mcfg = torch_cfg(JaxConfig(**{**MOE, "n_embd": 256, "n_ff_exp": 256, "n_heads": 4,
                                  "head_dim": 64}))
    mw = tllama.random_weights(mcfg, seed=2, dtype=torch.float32)
    mw = dataclasses.replace(mw, layers=[dataclasses.replace(lw, moe=quantize_experts(lw.moe))
                                         for lw in mw.layers])
    step, params, _, opt = ts.make_sharded_train_step(
        mcfg, ts.make_train_mesh(devices=["cpu"] * 4, ep=2), mw)
    with pytest.raises(NotImplementedError, match="packed"):
        step(params, opt, np.random.default_rng(0).integers(0, 64, (1, 9)))
    # a TCQ4 linear under a channel permutation
    pcfg = torch_cfg(JaxConfig(**TCQ4))
    pw = tllama.random_weights(pcfg, seed=3, quantize=True)
    rng = np.random.default_rng(0)
    t = quantize_tcq4((rng.standard_normal((pcfg.n_q_dim, pcfg.n_embd)) * 0.05).astype(np.float32),
                      perm=rng.permutation(pcfg.n_embd))
    eff = np.asarray(jlin.TCQ4Linear.from_tensor(t).eff, np.float32)
    pw.layers[0].wq = TCQ4Linear.from_arrays(t.qs, eff, perm=t.perm)
    step, params, _, opt = ts.make_sharded_train_step(
        pcfg, ts.make_train_mesh(devices=["cpu"] * 2), pw)
    with pytest.raises(NotImplementedError, match="channel permutation"):
        step(params, opt, np.random.default_rng(0).integers(0, 512, (1, 9)))


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _two_step_result(path: Path, devices, dp: int):
    """Two AdamW steps of the dense model over ``make_train_mesh(devices=
    devices, dp=dp)`` on a fixed batch: (losses, the joined parameters)."""
    tcfg, tw = load_model(path, dtype=torch.float32, fuse=False, device="cpu")[:2]
    batch = np.random.default_rng(1).integers(0, 64, (2, 9), dtype=np.int32)
    step, params, _, opt = ts.make_sharded_train_step(
        tcfg, ts.make_train_mesh(devices=devices, dp=dp), tw, tft.TrainConfig(lr=1e-2))
    losses = []
    for _ in range(2):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    return losses, _flat(params.joined())


def test_two_process_dp_rows_match_one_process(tmp_path):
    """dp rows held by different processes: two OS processes, each with the
    two CPU shards of one dp row of a dp 2 x tp 2 mesh, joined in one gloo
    group; each reduces its gradients with the other's after the backward.
    Both print the losses and hold the parameters of one process running
    the four shards (within 1e-6). A dp row across two processes (tp and ep
    groups that span processes, ROADMAP A12d) is refused. The worker is this
    file run as a script: python tests/test_torch_train_sharding.py <pid>
    <nprocs> <port> <gguf> <out.npz>"""
    export_random_gguf(JaxConfig(**DENSE), tmp_path / "dense.gguf", seed=4)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, __file__, str(pid), "2", str(port),
                               str(tmp_path / "dense.gguf"), str(tmp_path / f"rank{pid}.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=str(ROOT), env=env)
             for pid in range(2)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err[-4000:]}"
            assert "A12D_REFUSED" in out, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    losses, ref = _two_step_result(tmp_path / "dense.gguf", ["cpu"] * 4, dp=2)
    for pid in range(2):
        got = dict(np.load(tmp_path / f"rank{pid}.npz"))
        np.testing.assert_allclose(got.pop("losses"), losses, rtol=0, atol=1e-6)
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert _rel(got[k], v) <= 1e-6, k


def _worker(pid: int, nprocs: int, port: int, gguf: str, out: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=nprocs,
                            rank=pid)
    try:
        try:
            ts.make_train_mesh(devices=["cpu"], dp=1)
        except NotImplementedError as e:
            assert "A12d" in str(e)
            print("A12D_REFUSED", flush=True)
        mesh = ts.make_train_mesh(devices=["cpu"] * 2, dp=2)
        assert mesh.shape == {"dp": 2, "tp": 2} and mesh.shards() == [(pid, 0, 0), (pid, 0, 1)]
        losses, params = _two_step_result(Path(gguf), ["cpu"] * 2, dp=2)
        np.savez(out, losses=np.asarray(losses), **params)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
