"""SPMD training step over a (dp, ep, tp) mesh of shards.

Port of ``rrs_tpu/parallel/train_step.py``. The JAX package annotates the
parameters and the batch with shardings over a ("dp", "ep", "tp") mesh and
lets GSPMD partition ``jax.value_and_grad`` of ``_loss_fn``. Here the mesh
is the serving ``Mesh`` with an ep extent, a (dp, ep, tp) grid of shards,
each a ``torch.device`` (several may share one card), and every shard runs
``_loss_fn`` over its slice of the weights in a thread of its own
(``ShardThreads``):

  dp  the batch rows; each dp row's shards hold the same slices
  ep  MoE expert stacks cut on E: each ep rank runs its experts over its
      row's tokens, ep rank 0's MoE inputs (the routing is replicated), and
      the routed output sums over the row's ep x tp shards before
      ``down_b``; only ep rank 0 runs the rest of the model
  tp  heads and FFN columns, the serving mesh's plan (``sharding.weight_shard``); the
      lm_head's vocab shards are gathered, and each tp rank scores its T / tp
      of the positions (the JAX step's P(dp, tp, None) constraint on the
      logits, sp-over-tp), so no shard holds the whole [B, T, V] f32
      log-probabilities

The loss is the sum of the shards' shares of the global mean, and one
backward runs over the whole graph from the calling thread. A row-parallel
sum (``TPGroup``) is one tensor built from the shards' partial products and
read by every shard of its group, so its gradient is the sum of what every
shard sends back, the replicated activations' gradient included; and no
collective runs inside the backward. Each shard's slice of a leaf is a
"piece": its shards on one device share one tensor, so autograd sums their
contributions; the copies of a piece on other devices (and, across
processes, in other processes' dp rows) are summed after the backward. The
optimizer (``finetune.Optimizer``, optax's arithmetic) steps each piece once
a device, its AdamW state beside it, and the clip divides by the norm over
the whole model: every piece counted once.

A mesh may span processes (``torch.distributed``, gloo or NCCL) where each
process holds whole dp rows; a tp or ep group across processes raises
NotImplementedError (ROADMAP A12d). Entry points run on ``cuda`` unless
given CPU devices, and raise without a GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.parallel.sharding import (ExpertComm, Mesh, ShardComm, ShardThreads, _cut,
                                             _local_cfg, make_mesh, weight_shard)
from rrs_tpu_torch.train.finetune import (TrainConfig, _is_float, _loss_fn, _tree_map, combine,
                                          make_optimizer, partition)


def make_train_mesh(n_devices: int = 0, dp: int = 1, ep: int = 1, devices=None) -> Mesh:
    """A (dp, ep, tp) mesh (``sharding.make_mesh``); tp takes the shards that
    remain. ``devices`` (default: the first ``n_devices`` CUDA devices, all
    of them with 0) are this process's shards, and a device may repeat:
    ``make_train_mesh(devices=["cuda:0"] * 8, dp=2, ep=2)`` puts dp 2 x ep 2
    x tp 2 on one card. Under ``torch.distributed`` every process passes its
    own shards and the mesh takes them process-major; each process must hold
    whole dp rows."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world == 1:
        return make_mesh(n_devices, dp, devices, ep=ep)
    local = make_mesh(n_devices, 1, devices).devices
    n, k = len(local) * world, len(local)
    if n % (dp * ep):
        raise ValueError(f"{n} shards do not split into dp={dp} x ep={ep}")
    if k % (n // dp):
        raise NotImplementedError(
            f"a dp row of {n // dp} shards across processes of {k} shards: tp and ep groups "
            "that span processes are ROADMAP item A12d; give each process whole dp rows")
    me = dist.get_rank()
    return Mesh(devices=[local[g % k] if g // k == me else None for g in range(n)],
                dp=dp, ep=ep, owners=tuple(g // k for g in range(n)))


# -- the plan: tp as the serving mesh's, the expert stacks also on E over ep ------

_EXPERT_STACKS = ("gate", "up", "down", "gate_qs", "gate_eff", "up_qs", "up_eff", "down_qs",
                  "down_eff", "gate_b", "up_b", "down_b")


def train_weight_shard(weights, e: int, r: int, ep: int, tp: int):
    """Slice (e, r) of every leaf, views of ``weights``: the tp plan of
    ``weight_shard``, then the expert stacks (dense and packed) and their
    biases cut on E over ep, as JAX's ``_moe_pspecs``. Every other leaf is
    whole. Fused projections raise, as in JAX."""
    w = weight_shard(weights, r, tp)
    if ep == 1:
        return w
    layers = []
    for lw in w.layers:
        if lw.moe is not None:
            if lw.moe.router.shape[-1] % ep:
                raise ValueError(f"{lw.moe.router.shape[-1]} experts do not split over ep={ep}")
            lw = dataclasses.replace(lw, moe=dataclasses.replace(
                lw.moe, **{f: _cut(getattr(lw.moe, f), 0, e, ep) for f in _EXPERT_STACKS}))
        layers.append(lw)
    return dataclasses.replace(w, layers=layers)


def _flat(tree) -> list:
    """Every leaf of a tree (None and non-tensors too), in ``_tree_map``'s
    order: the same positions for every slice of one model."""
    out = []
    _tree_map(out.append, tree)
    return out


def _rebuild(tree, leaves: list):
    """``tree``'s structure with ``leaves`` (``_flat``'s order) in place."""
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def _piece_key(i: int, t: torch.Tensor) -> tuple:
    """A slice's identity: its position in the tree and the view it is of
    the caller's tensor (replicated leaves are the same view in every
    slice; a cut leaf's slices are different views)."""
    return (i, t.data_ptr(), tuple(t.shape), tuple(t.stride()))


@dataclasses.dataclass
class ShardedWeights:
    """The weights over a ``Mesh``: ``shards`` maps each local shard
    (d, e, r) to its slice of every leaf on its device, and ``keys`` to each
    leaf's piece key (``_flat``'s order, None where not a tensor); the
    shards of one device share each piece's tensor. ``views`` holds slice
    (e, r) as views of ``full``, the caller's weights."""

    mesh: Mesh
    full: object
    views: dict
    shards: dict
    keys: dict

    def join(self, values: dict):
        """The whole-model tree of a per-shard tree of values (a leaf's
        slices put back where they were cut from, on the CPU): ``values``
        maps (d, e, r) to a tree of this model's structure, None where there
        is no value."""
        full = _flat(self.full)
        views = {er: _flat(v) for er, v in self.views.items()}
        by_slice = {}
        for (d, e, r), tree in values.items():
            by_slice.setdefault((e, r), _flat(tree))
        out = []
        for i, leaf in enumerate(full):
            vals = {er: leaves[i] for er, leaves in by_slice.items()}
            if not isinstance(leaf, torch.Tensor) or any(v is None for v in vals.values()):
                out.append(None)
                continue
            dt = next(iter(vals.values())).dtype
            joined = torch.empty_strided(leaf.shape, leaf.stride(), dtype=dt)
            for er, v in vals.items():
                view = views[er][i]
                joined.as_strided(view.shape, view.stride(),
                                  view.storage_offset() - leaf.storage_offset()).copy_(
                    v.detach().cpu())
            out.append(joined)
        return _rebuild(self.full, out)


def shard_train_weights(weights, mesh: Mesh) -> ShardedWeights:
    """Every local shard's slice of the weights (``train_weight_shard``), on
    its device: replicated over dp (and over ep where no stack is cut),
    each piece placed once a device."""
    views = {(e, r): train_weight_shard(weights, e, r, mesh.ep, mesh.tp)
             for e in range(mesh.ep) for r in range(mesh.tp)}
    placed, shards, keys = {}, {}, {}
    for d, e, r in mesh.shards():
        dev = str(mesh.device(d, r, e))
        leaves, ks = [], []
        for i, x in enumerate(_flat(views[(e, r)])):
            key = _piece_key(i, x) if isinstance(x, torch.Tensor) else None
            if key is not None and (dev, key) not in placed:
                placed[(dev, key)] = x.to(dev).contiguous()
            leaves.append(x if key is None else placed[(dev, key)])
            ks.append(key)
        shards[(d, e, r)] = _rebuild(views[(e, r)], leaves)
        keys[(d, e, r)] = ks
    return ShardedWeights(mesh=mesh, full=weights, views=views, shards=shards, keys=keys)


@dataclasses.dataclass
class ShardedBatch:
    """A [B, T+1] token batch over a mesh: ``rows`` maps each local dp row
    to its B / dp rows (int64, on the host)."""

    shape: tuple
    rows: dict


def shard_batch(batch, mesh: Mesh) -> ShardedBatch:
    """The rows of a [B, T+1] token batch split over dp (every process
    passes the whole batch and keeps its rows)."""
    b = torch.as_tensor(np.asarray(batch), dtype=torch.int64)
    if b.shape[0] % mesh.dp:
        raise ValueError(f"batch of {b.shape[0]} rows does not split over dp={mesh.dp}")
    n = b.shape[0] // mesh.dp
    return ShardedBatch(shape=tuple(b.shape),
                        rows={d: b[d * n:(d + 1) * n] for d, _ in mesh.local()})


# -- the step ---------------------------------------------------------------------

@dataclasses.dataclass
class TrainShard:
    d: int                      # dp row
    e: int                      # ep rank
    r: int                      # tp rank
    device: torch.device
    cfg: ModelConfig            # the local config


@dataclasses.dataclass
class ShardedParams:
    """The trained leaves over a mesh: ``trees`` maps each local shard to
    its tree of parameters (None where frozen); ``leaves`` holds each piece
    once a device, in a fixed order. The step updates them in place; after
    it, each leaf's ``grad`` holds its piece's gradient over the whole
    model."""

    trees: dict
    leaves: list
    weights: ShardedWeights

    def joined(self):
        """The parameters as one whole-model tree on the CPU."""
        return self.weights.join(self.trees)

    def joined_grads(self):
        """The last step's gradients as one whole-model tree on the CPU
        (zeros where a parameter got none)."""
        grads = {k: _tree_map(lambda p: None if p is None else
                              (torch.zeros_like(p) if p.grad is None else p.grad), t)
                 for k, t in self.trees.items()}
        return self.weights.join(grads)


class TrainModel(ShardThreads):
    """The shards of a training mesh: each local shard's local config (its
    tp group's ``ShardComm``; under ep its row's ``ExpertComm``) and the
    threads that run them. Under ep, the shards of ep rank 0 run the model
    and the loss; those of the other ep ranks run only their experts, on ep
    rank 0's inputs (``ExpertComm.share``): computing the rest redundantly
    would split the gradient of every replicated activation into per-rank
    parts, which the bf16 K / V caches round one at a time."""

    @staticmethod
    def _key(shard):
        return (shard.d, shard.e, shard.r)

    def __init__(self, cfg: ModelConfig, mesh: Mesh):
        self.cfg = cfg
        self.mesh = mesh
        tp, ep = mesh.tp, mesh.ep
        _local_cfg(cfg, tp)
        if ep > 1 and cfg.n_experts % ep:
            raise ValueError(f"{cfg.n_experts} experts do not split over ep={ep}")
        super().__init__()
        n_loc = cfg.n_experts // ep
        self.shards = []
        for d, e, r in mesh.shards():
            comm = ep_comm = None
            if tp > 1:
                comm = ShardComm(self._group(("tp", d, e), {rr: mesh.device(d, rr, e)
                                                            for rr in range(tp)}), r)
            if ep > 1:
                row = self._group(("ep", d), {ee * tp + rr: mesh.device(d, rr, ee)
                                              for ee in range(ep) for rr in range(tp)})
                peers = self._group(("share", d, r), {ee: mesh.device(d, r, ee)
                                                      for ee in range(ep)})
                ep_comm = ExpertComm(row, e * tp + r, e * n_loc, n_loc, peers, e)
            self.shards.append(TrainShard(d, e, r, mesh.device(d, r, e),
                                          _local_cfg(cfg, tp, comm, ep_comm)))
        self._start("rrs-train-shard")

    def logits_sharding(self, shard: TrainShard, t: int, count: int):
        """The ``_loss_fn`` argument of an ep rank 0 shard: its row's logits
        gathered over tp and cut to the vocab, and its tp rank's share of the
        T positions (JAX's P(dp, tp, None))."""
        tp = self.mesh.tp
        part = slice(t * shard.r // tp, t * (shard.r + 1) // tp)

        def fn(logits):
            if shard.cfg.tp_axis is not None:
                logits = shard.cfg.tp_axis.all_gather(logits)
            return logits[..., : self.cfg.vocab_size], part, count

        return fn


def _experts_only(cfg: ModelConfig, weights) -> None:
    """An ep rank > 0 shard's part of the forward: each MoE layer's experts
    on ep rank 0's input (``moe_ffn`` takes it through ``ExpertComm``), their
    output summed into ep rank 0's."""
    from rrs_tpu_torch.models.moe import moe_ffn

    for lw in weights.layers:
        if lw.moe is not None:
            moe_ffn(cfg, lw.moe, None)


def make_sharded_train_step(cfg: ModelConfig, mesh: Mesh, weights,
                            tc: Optional[TrainConfig] = None):
    """The SPMD train step, as the JAX ``make_sharded_train_step``: returns
    (step, params, static, opt_state) where ``step(params, opt_state,
    batch) -> (params, opt_state, loss)``; ``batch`` is a [B, T+1] token
    array or ``shard_batch``'s. Weights are sharded here (tp on heads and
    FFN, ep on expert stacks); ``params`` (a ``ShardedParams``) and
    ``opt_state`` (the optimizer) are updated in place and returned, and
    ``loss`` is the global batch's mean on the first local shard's device.
    ``static`` maps each local shard to its frozen leaves. The caller's
    weights are left as they were; the float pieces that sharding copied
    are the parameters themselves (``params.weights.shards`` moves with
    them)."""
    tc = tc or TrainConfig()
    sw = shard_train_weights(weights, mesh)
    model = TrainModel(cfg, mesh)
    clones: dict = {}                       # (device, piece key) -> its trained leaf
    leaves, keys = [], []
    trees, static = {}, {}
    for s in model.shards:
        key = model._key(s)
        flat = []
        for x, v, k in zip(_flat(sw.shards[key]), _flat(sw.views[(s.e, s.r)]), sw.keys[key]):
            if not _is_float(x):
                flat.append(None)
                continue
            if (str(s.device), k) not in clones:
                # a piece placed as a copy trains in place; one that is the
                # caller's tensor is copied first, so the caller's weights
                # stay as they were
                own = x.untyped_storage().data_ptr() != v.untyped_storage().data_ptr()
                clones[(str(s.device), k)] = (x.detach() if own else x.detach().clone()
                                              ).requires_grad_(True)
                leaves.append(clones[(str(s.device), k)])
                keys.append(k)
            flat.append(clones[(str(s.device), k)])
        trees[key] = _rebuild(sw.shards[key], flat)
        static[key] = partition(sw.shards[key])[1]
    params = ShardedParams(trees=trees, leaves=leaves, weights=sw)
    # the copies of one piece on the devices of this process
    copies: dict = {}
    for i, k in enumerate(keys):
        copies.setdefault(k, []).append(i)
    import torch.distributed as dist

    spans = bool(mesh.owners) and dist.is_initialized() and dist.get_world_size() > 1

    def step(params: ShardedParams, opt_state, batch):
        if not isinstance(batch, ShardedBatch):
            batch = shard_batch(batch, mesh)
        for p in params.leaves:
            p.grad = None
        count = batch.shape[0] * (batch.shape[1] - 1)

        def one(shard):
            key = model._key(shard)
            w = combine(params.trees[key], static[key])
            if shard.e:
                return _experts_only(shard.cfg, w)
            return _loss_fn(shard.cfg, w, batch.rows[shard.d],
                            logits_sharding=model.logits_sharding(shard, batch.shape[1] - 1, count))

        with torch.enable_grad():
            parts = [p for p in model.run(one) if p is not None]
            dev0 = parts[0].device
            # one node over every part: the backward then starts every
            # shard's graph at once, whatever this thread's count of the
            # nodes it made (see ``TPGroup``), so the gradients repeat
            loss = torch.stack([p.to(dev0) for p in parts]).sum()
        loss.backward()
        grads = _reduce_grads(params.leaves, copies, spans)
        # the global norm: each piece once
        sq = None
        if tc.clip_norm > 0:
            sq = torch.zeros((), dtype=torch.float32, device=dev0)
            for idx in copies.values():
                g = grads[idx[0]]
                if g is not None:
                    sq = sq + torch.sum(g.to(torch.float32) ** 2).to(dev0)
        opt_state.step(params.leaves, grads, sq_norm=sq)
        loss = loss.detach()
        if spans:
            dist.all_reduce(loss)
        return params, opt_state, loss

    step.model = model
    return step, params, static, make_optimizer(tc)


def _reduce_grads(leaves: list, copies: dict, spans: bool) -> list:
    """Each piece's gradient over the whole model, on each of its copies:
    the sum of its copies' gradients in f32 (across processes too), cast to
    the piece's dtype. A piece no shard's loss reached gets None."""
    import torch.distributed as dist

    grads = [p.grad for p in leaves]
    for idx in copies.values():
        got = [grads[i] for i in idx if grads[i] is not None]
        if len(idx) == 1 and not spans:
            continue
        if not got and not spans:
            continue
        dev = leaves[idx[0]].device
        total = torch.zeros(leaves[idx[0]].shape, dtype=torch.float32, device=dev)
        for g in got:
            total = total + g.to(dev, torch.float32)
        if spans:
            dist.all_reduce(total)
        for i in idx:
            grads[i] = total.to(leaves[i].device, leaves[i].dtype)
            leaves[i].grad = grads[i]
    return grads
