"""Tensor / data parallel sharding over a (dp, tp) mesh of shards.

Port of ``rrs_tpu/parallel/sharding.py``. The JAX package runs one program
over a ("dp", "tp") mesh of devices under ``shard_map``. Here a ``Mesh`` is a
(dp, tp) grid of *shards*, each a ``torch.device`` (several shards may share
one device), and the port's unchanged forward (``llama.forward``, with its
MLA, MoE and gemma branches) runs once for each shard, in a thread of its
own, on the shard's slice of the weights and of the KV cache with the local
config (``_local_cfg``: heads, kv heads and FFN width over tp). The shards of
one dp row meet in a ``TPGroup``:

  * ``all_reduce``: the f32 sum of the partial products of a row-parallel
    linear, added in rank order, before the bias and the output cast
    (``linear_apply``'s ``reduce_axis``, as rrs_tpu/models/linear.py:489-494);
  * ``all_gather``: the vocab shards of the column-parallel lm_head,
    concatenated in rank order; the caller cuts them to ``cfg.vocab_size``.

Plan (per layer), as the JAX package's:
  wq / wk / wv, gate / up : column-parallel (N on tp)     -> no collective
  wo, down               : row-parallel (K on tp)         -> all_reduce
  KV cache               : kv heads on tp (an MLA latent row whole), lanes on dp
  embed                  : replicated; lm_head column-parallel -> all_gather

The TCQ4 256-blocks make row-parallel splits exact: FWHT blocks, activation
quant blocks and weight superblocks are K-block-local, so a K split at
256-multiples commutes with the whole W4A4 pipeline, and the i8p pack's three
arrays split on the same K rows. A channel permutation (``gather``) is
block-local (perm % 256): a row-parallel shard takes its K slice of it, a
column-parallel one the whole of it (the JAX plan splits it there too, which
the port does not copy: ROADMAP queue C).

A mesh may span processes (``parallel/distributed.py``): a row's collective
then first sums or gathers what this process's shards hold, then calls
``torch.distributed`` across the row's processes (NCCL for CUDA tensors, gloo
for CPU ones). A shard that raises aborts every row's barrier, so that no
shard waits for it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from rrs_tpu_torch import kernels
from rrs_tpu_torch.models import llama as llama_model
from rrs_tpu_torch.models.adapter import LoraLinear
from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.models.linear import DenseLinear, MXFP4Linear, Q8Linear, TCQ4Linear
from rrs_tpu_torch.models.moe import MoEWeights
from rrs_tpu_torch.runtime.context import step_inputs


@dataclasses.dataclass
class Mesh:
    """A (dp, ep, tp) grid of shards, row-major: shard (d * ep + e) * tp + r
    is tp rank r of ep rank e of dp row d (a serving mesh has ep = 1).
    ``devices`` holds each shard's ``torch.device``, or None for a shard of
    another process; ``owners`` each shard's process rank (empty in one
    process); ``groups`` each row's ``torch.distributed`` group when the row
    spans processes (else None)."""

    devices: list
    dp: int = 1
    owners: tuple = ()
    groups: tuple = ()
    ep: int = 1

    @property
    def tp(self) -> int:
        return len(self.devices) // (self.dp * self.ep)

    @property
    def shape(self) -> dict:
        """The extents, as the JAX mesh's: ep only where the mesh has one."""
        return ({"dp": self.dp, "ep": self.ep, "tp": self.tp} if self.ep > 1
                else {"dp": self.dp, "tp": self.tp})

    def index(self, d: int, r: int, e: int = 0) -> int:
        return (d * self.ep + e) * self.tp + r

    def device(self, d: int, r: int, e: int = 0) -> Optional[torch.device]:
        return self.devices[self.index(d, r, e)]

    def shards(self) -> list:
        """(d, e, r) of every shard this process holds."""
        return [(d, e, r) for d in range(self.dp) for e in range(self.ep)
                for r in range(self.tp) if self.device(d, r, e) is not None]

    def local(self) -> list:
        """(d, r) of every shard this process holds (a mesh without ep)."""
        return [(d, r) for d, _, r in self.shards()]

    def owner(self, d: int) -> int:
        """The process that reports dp row d's outputs (its tp rank 0's)."""
        return self.owners[self.index(d, 0)] if self.owners else 0

    def rows_everywhere(self) -> bool:
        """Whether every process holds a shard of every dp row (so that each
        has every row's outputs after the rows' gathers)."""
        procs, n = set(self.owners), self.ep * self.tp
        return all(set(self.owners[d * n:(d + 1) * n]) == procs for d in range(self.dp))


def make_mesh(n_devices: int = 0, dp: int = 1, devices=None, ep: int = 1) -> Mesh:
    """A (dp, ep, tp = n / (dp * ep)) mesh over ``devices`` (default: the
    first ``n_devices`` CUDA devices, all of them with 0). A device may
    repeat: ``make_mesh(devices=[torch.device("cuda:0")] * 4, dp=2)`` puts tp
    2 x dp 2 on one card."""
    if devices is None:
        from rrs_tpu_torch.device import resolve_device

        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devices = devices[: n_devices or len(devices)]
    devices = [torch.device(d) for d in devices]
    # each shard's thread sets its device, which needs an index
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d for d in devices]
    if not devices or len(devices) % (dp * ep):
        what = f"dp={dp} rows" if ep == 1 else f"dp={dp} x ep={ep}"
        raise ValueError(f"{len(devices)} shards do not split into {what}")
    return Mesh(devices=devices, dp=dp, ep=ep)


# -- the plan: slicing rules per leaf ------------------------------------------

def _cut(t: Optional[torch.Tensor], dim: int, r: int, tp: int) -> Optional[torch.Tensor]:
    """Rank r's equal slice of ``t`` along ``dim`` (None stays None)."""
    if t is None or tp == 1:
        return t
    n = t.shape[dim]
    if n % tp:
        raise ValueError(f"axis {dim} of a {tuple(t.shape)} weight does not split over tp={tp}")
    return t.narrow(dim, r * (n // tp), n // tp)


def _linear_shard(lin, col: bool, r: int, tp: int):
    """Rank r's shard of a linear: column-parallel splits N (axis 1 of the
    K-major arrays) and the bias; row-parallel splits K (axis 0) and keeps
    the bias whole, added once after the reduce."""
    if lin is None:
        return None
    if isinstance(lin, LoraLinear):
        raise NotImplementedError("a LoRA-wrapped linear cannot be tensor-sharded "
                                  "(nor can the JAX package's)")
    ax = 1 if col else 0
    bias = _cut(lin.bias, 0, r, tp) if col else lin.bias
    if isinstance(lin, DenseLinear):
        return DenseLinear(w=_cut(lin.w, ax, r, tp), bias=bias)
    if isinstance(lin, Q8Linear):
        # K padding (zero rows at the GLOBAL end) would land in the last
        # shard only while the activations split by logical K
        if not col and lin.k_logical:
            raise ValueError(
                f"K-padded Q8Linear cannot be row-sharded (K {lin.k_logical} padded to "
                f"{lin.q.shape[0]}); use a model dim that is a multiple of 256, or keep "
                "this projection dense")
        return Q8Linear(q=_cut(lin.q, ax, r, tp), scale=_cut(lin.scale, ax, r, tp), bias=bias,
                        n_logical=lin.n_logical, k_logical=lin.k_logical)
    if isinstance(lin, MXFP4Linear):
        # pad columns would land mid-shard
        if col and lin.n_logical and lin.n_logical != lin.qs.shape[1]:
            raise ValueError("N-padded MXFP4Linear cannot be column-sharded")
        return MXFP4Linear(qs=_cut(lin.qs, ax, r, tp), scale=_cut(lin.scale, ax, r, tp),
                           bias=bias, n_logical=lin.n_logical)
    if isinstance(lin, TCQ4Linear):
        if not col and (lin.shape[0] // tp) % 256:
            raise ValueError(
                f"TCQ4 activation width {lin.shape[0] // tp} not a multiple of 256; for "
                "row-parallel TP shards, (K / tp) must stay 256-aligned")
        i8p = None if lin.i8p is None else tuple(_cut(a, ax, r, tp) for a in lin.i8p)
        return TCQ4Linear(qs=_cut(lin.qs, ax, r, tp), eff=_cut(lin.eff, ax, r, tp),
                          gather=lin.gather if col else _cut(lin.gather, 0, r, tp),
                          bias=bias, i8p=i8p)
    raise TypeError(f"unknown linear layer {type(lin)}")


def _moe_shard(mw: Optional[MoEWeights], r: int, tp: int) -> Optional[MoEWeights]:
    """Dense expert stacks pair column-parallel gate / up with row-parallel
    down on F (so the routed output is a partial sum), as does the shared
    expert; packed (kernel-layout) stacks stay whole on every shard. gate /
    up biases follow the dense stacks' F split; down_b stays whole."""
    if mw is None:
        return None
    dense = mw.gate is not None
    return dataclasses.replace(
        mw, gate=_cut(mw.gate, 2, r, tp), up=_cut(mw.up, 2, r, tp),
        down=_cut(mw.down, 1, r, tp),
        shared_gate=_cut(mw.shared_gate, 1, r, tp), shared_up=_cut(mw.shared_up, 1, r, tp),
        shared_down=_cut(mw.shared_down, 0, r, tp),
        gate_b=_cut(mw.gate_b, 1, r, tp) if dense else mw.gate_b,
        up_b=_cut(mw.up_b, 1, r, tp) if dense else mw.up_b)


def weight_shard(weights: llama_model.ModelWeights, r: int, tp: int) -> llama_model.ModelWeights:
    """tp rank r's slice of every leaf (views where the slice allows), per
    the plan of ``weight_pspecs`` (rrs_tpu/parallel/sharding.py:174-230).
    MLA: wq_a / wkv_a and their norms stay whole (they feed the one latent
    row every head attends), wq (= wq_b) splits on heads, wk_b / wv_b on
    their head axis, wo on K; gpt-oss's sinks split on heads."""
    layers = []
    for lw in weights.layers:
        if lw.wqkv is not None or lw.w_gateup is not None:
            raise ValueError("fused projections cannot be TP-sharded; load with fuse=False")
        layers.append(dataclasses.replace(
            lw,
            wq=_linear_shard(lw.wq, True, r, tp), wk=_linear_shard(lw.wk, True, r, tp),
            wv=_linear_shard(lw.wv, True, r, tp), wo=_linear_shard(lw.wo, False, r, tp),
            w_gate=_linear_shard(lw.w_gate, True, r, tp),
            w_up=_linear_shard(lw.w_up, True, r, tp),
            w_down=_linear_shard(lw.w_down, False, r, tp),
            moe=_moe_shard(lw.moe, r, tp), attn_sinks=_cut(lw.attn_sinks, 0, r, tp),
            wk_b=_cut(lw.wk_b, 0, r, tp), wv_b=_cut(lw.wv_b, 0, r, tp)))
    lm_head = weights.lm_head
    if isinstance(lm_head, Q8Linear) and lm_head.n_logical:
        # a padded vocab is cut after the gather, never per shard
        lm_head = dataclasses.replace(lm_head, n_logical=0)
    return dataclasses.replace(weights, layers=layers,
                               lm_head=_linear_shard(lm_head, True, r, tp))


def _place(obj, device: torch.device):
    """A copy of a weights tree whose every tensor lies on ``device``,
    contiguous (the kernels take nothing else)."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device).contiguous()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _place(getattr(obj, f.name), device) for f in dataclasses.fields(obj)})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_place(o, device) for o in obj)
    return obj


def shard_weights(weights: llama_model.ModelWeights, mesh: Mesh) -> list:
    """Every local shard's weights, on its device (None for another
    process's shard), indexed like ``mesh.devices``. Shards of one tp rank
    on one device share their tensors."""
    made = {}
    out = [None] * len(mesh.devices)
    for d, r in mesh.local():
        dev = mesh.device(d, r)
        key = (r, str(dev))
        if key not in made:
            made[key] = _place(weight_shard(weights, r, mesh.tp), dev)
        out[d * mesh.tp + r] = made[key]
    return out


def _local_cfg(cfg: ModelConfig, tp: int, comm=None, ep_comm=None) -> ModelConfig:
    """A shard's config: heads, kv heads (MLA: the latent row stays whole)
    and FFN width over tp; ``tp_axis`` the shard's handle on its row's
    collectives; ``ep_axis`` (a training mesh's ``ExpertComm``) the expert
    ids the shard holds and the handle over which the routed output sums."""
    if cfg.n_heads % tp:
        raise ValueError(f"heads {cfg.n_heads} not divisible by tp={tp}")
    if cfg.n_ff % tp:
        raise ValueError(f"n_ff {cfg.n_ff} not divisible by tp={tp}")
    if cfg.is_mla:
        return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp, n_ff=cfg.n_ff // tp,
                                   tp_axis=comm, ep_axis=ep_comm)
    if cfg.n_kv_heads % tp:
        raise ValueError(f"kv heads {cfg.n_kv_heads} not divisible by tp={tp}")
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
                               n_ff=cfg.n_ff // tp, tp_axis=comm, ep_axis=ep_comm)


# -- the collectives -------------------------------------------------------------

class TPGroup:
    """The collectives of one dp row: every local shard of the row hands in
    its tensor and waits at one barrier; the barrier's action (run once, by
    the last to arrive) sums or concatenates them in rank order, crosses
    processes through ``torch.distributed`` when the row spans several, and
    leaves the result on each shard's device. ``counts`` and ``bytes``
    tally the collectives run and one shard's payloads (the schedule the
    tests pin).

    Under autograd the lowest rank's own thread builds the result, between
    two barriers, and not whichever thread came last: the backward runs a
    graph's nodes in the order of their sequence numbers, which each thread
    counts on its own, and sums the gradients a tensor gets in that order,
    so the nodes must come from the same thread in every run for the
    gradients to repeat bit for bit."""

    def __init__(self, devices: dict, dist_group=None, turn: Optional[threading.Lock] = None):
        self.devices = devices                    # tp rank -> torch.device, this process's
        self.ranks = sorted(devices)
        self.dist_group = dist_group
        self.turn = turn                          # the shards' turn to run (``ShardedModel``)
        self.barrier = threading.Barrier(len(self.ranks), action=self._action)
        self._ordered = False
        self.counts = {"all_reduce": 0, "all_gather": 0}
        self.bytes = {"all_reduce": 0, "all_gather": 0}     # one shard's payloads
        self._parts: dict = {}
        self._op = ""
        self._out: dict = {}

    def collect(self, rank: int, op: str, x: torch.Tensor) -> torch.Tensor:
        self._parts[rank] = x
        self._op = op
        self._ordered = torch.is_grad_enabled()
        if self.turn is not None:
            self.turn.release()
        try:
            self.barrier.wait()
            if self._ordered:
                if rank == self.ranks[0]:
                    with self.turn or contextlib.nullcontext():
                        self._combine()
                self.barrier.wait()
        finally:
            if self.turn is not None:
                self.turn.acquire()
        return self._out[str(self.devices[rank])]

    def _action(self) -> None:
        if not self._ordered:
            self._combine()

    def _combine(self) -> None:
        import torch.distributed as dist

        xs = [self._parts[r] for r in self.ranks]
        dev0 = xs[0].device
        if self._op == "all_reduce":
            acc = xs[0]
            for x in xs[1:]:
                acc = acc + x.to(dev0)
            if self.dist_group is not None:
                acc = acc.clone() if len(xs) == 1 else acc
                dist.all_reduce(acc, group=self.dist_group)
        elif self._op == "share":
            acc = xs[0]                           # rank 0's tensor, to every rank
        else:
            acc = torch.cat([x.to(dev0) for x in xs], dim=-1)
            if self.dist_group is not None:
                acc = acc.contiguous()
                parts = [torch.empty_like(acc)
                         for _ in range(dist.get_world_size(self.dist_group))]
                dist.all_gather(parts, acc, group=self.dist_group)
                acc = torch.cat(parts, dim=-1)
        self.counts[self._op] = self.counts.get(self._op, 0) + 1
        self.bytes[self._op] = self.bytes.get(self._op, 0) + xs[0].numel() * xs[0].element_size()
        self._out = {}
        for r in self.ranks:
            key = str(self.devices[r])
            if key not in self._out:
                self._out[key] = acc if self.devices[r] == dev0 else acc.to(self.devices[r])
        self._parts = {}


class ShardComm:
    """One shard's handle on its row's ``TPGroup`` (a local config's
    ``tp_axis``)."""

    def __init__(self, group: TPGroup, rank: int):
        self.group = group
        self.rank = rank

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return self.group.collect(self.rank, "all_reduce", x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return self.group.collect(self.rank, "all_gather", x)


class ExpertComm(ShardComm):
    """A shard's handle on the (ep x tp) group of its dp row (a training
    mesh's ``ep_axis``): the shard holds experts ``first`` .. ``first +
    count - 1`` of the stacks, the routed output of the dense experts sums
    over the group (``models/moe.py``), and ``share`` hands ep rank 0's
    input of an MoE layer to the ep ranks of its tp rank (``peers``, ranked
    by ep rank), which run no other part of the model."""

    def __init__(self, group: TPGroup, rank: int, first: int, count: int, peers: TPGroup,
                 ep_rank: int):
        super().__init__(group, rank)
        self.first = first
        self.count = count
        self.peers = peers
        self.ep_rank = ep_rank

    def share(self, x: Optional[torch.Tensor]) -> torch.Tensor:
        return self.peers.collect(self.ep_rank, "share", x)


@dataclasses.dataclass
class Shard:
    d: int                      # dp row
    r: int                      # tp rank
    device: torch.device
    cfg: ModelConfig            # the local config
    weights: llama_model.ModelWeights


class ShardThreads:
    """One thread a shard, the same thread for the shard in every call,
    that runs a function on every local shard at once (``run``), and the
    collective groups the shards meet in (``groups``, by any key,
    ``_group``). The subclass calls ``__init__``, makes its groups, sets
    ``shards`` and then calls ``_start``; ``launches`` holds each shard's
    kernel launch counts, by ``_key``.

    The shards take turns: a shard holds ``_turn`` while it runs and lets it
    go only while it waits at a collective, so one thread at a time issues
    work. Python runs one thread at a time anyway; two threads launching
    CUDA kernels at once contend for the CUDA context's launch lock (about
    5x the time a launch) and for the interpreter lock at every ``ctypes``
    call, and the launches of shards on distinct GPUs stay asynchronous, so
    their device work still overlaps."""

    def __init__(self):
        self._turn = threading.Lock()
        self._running = threading.Lock()          # one run at a time shares the barriers
        self.groups = {}

    @staticmethod
    def _key(shard):
        return (shard.d, shard.r)

    def _group(self, key, devices: dict, dist_group=None) -> TPGroup:
        """The group ``key`` (made on first use) over ``devices`` (rank ->
        torch.device)."""
        if key not in self.groups:
            self.groups[key] = TPGroup(devices, dist_group, self._turn)
        return self.groups[key]

    def _start(self, name: str) -> None:
        """Each shard's thread (a shard always runs on its own: the backward's
        order follows each thread's count of the nodes it made, see
        ``TPGroup``) and its launch counts."""
        self._threads = {self._key(s): ThreadPoolExecutor(max_workers=1,
                                                          thread_name_prefix=name)
                         for s in self.shards}
        self.launches = {self._key(s): {} for s in self.shards}

    def run(self, fn) -> list:
        """fn(shard) on every local shard at once, each in its own thread
        under the caller's grad mode and with its CUDA device current;
        returns the results in shard order. A shard that raises aborts the
        barriers, so the others raise too, and its error is raised here."""
        inference = torch.is_inference_mode_enabled()
        grad = torch.is_grad_enabled()

        def one(shard):
            kernels.count_thread_launches(self.launches[self._key(shard)])
            self._turn.acquire()
            try:
                with torch.inference_mode(inference), torch.set_grad_enabled(grad):
                    if shard.device.type == "cuda":
                        torch.cuda.set_device(shard.device)
                    return fn(shard)
            except BaseException:
                for g in self.groups.values():
                    g.barrier.abort()
                raise
            finally:
                self._turn.release()
                kernels.count_thread_launches(None)

        with self._running:
            futures = [self._threads[self._key(s)].submit(one, s) for s in self.shards]
            errors = [f.exception() for f in futures]
            if any(e is not None for e in errors):
                for g in self.groups.values():
                    g.barrier.reset()
                first = next((e for e in errors if e is not None
                              and not isinstance(e, threading.BrokenBarrierError)),
                             next(e for e in errors if e is not None))
                raise first
            return [f.result() for f in futures]


class ShardedModel(ShardThreads):
    """A model over a mesh: each local shard's weights and local config, the
    rows' collectives, and the threads of ``ShardThreads``."""

    def __init__(self, cfg: ModelConfig, weights: llama_model.ModelWeights, mesh: Mesh):
        self.cfg = cfg
        self.mesh = mesh
        tp = mesh.tp
        _local_cfg(cfg, tp)                       # the divisibility checks, before any copy
        per_shard = shard_weights(weights, mesh)
        super().__init__()
        for d in range(mesh.dp):
            devs = {r: mesh.device(d, r) for r in range(tp) if mesh.device(d, r) is not None}
            if devs:
                self._group(d, devs, mesh.groups[d] if mesh.groups else None)
        self.shards = []
        for d, r in mesh.local():
            g = self.groups[d]
            comm = ShardComm(g, r) if (tp > 1 or g.dist_group is not None) else None
            self.shards.append(Shard(d, r, mesh.device(d, r), _local_cfg(cfg, tp, comm),
                                     per_shard[d * tp + r]))
        # each shard's kernel launches, by kernel (``kernels.LAUNCHES`` sums them)
        self._start("rrs-shard")

    def lanes(self, n_lanes: int, d: int) -> slice:
        bl = n_lanes // self.mesh.dp
        return slice(d * bl, (d + 1) * bl)

    def gather_logits(self, shard: Shard, logits: torch.Tensor) -> torch.Tensor:
        """The row's full logits from a shard's vocab slice, cut to the vocab."""
        if shard.cfg.tp_axis is not None:
            logits = shard.cfg.tp_axis.all_gather(logits)
        return logits[..., : self.cfg.vocab_size]

    def rows(self, results: list, device: torch.device) -> torch.Tensor:
        """The dp rows' outputs (the first local shard's of each row) stacked
        on the lane axis on ``device``. A row no shard of this process holds
        arrives from its owner through ``torch.distributed``."""
        first = {}
        for s, out in zip(self.shards, results):
            first.setdefault(s.d, out)
        if self.mesh.rows_everywhere():
            return torch.cat([first[d].to(device) for d in range(self.mesh.dp)], dim=0)
        import torch.distributed as dist

        # each row from its owner, zeros from every other process, summed
        me = dist.get_rank()
        like = next(iter(first.values()))
        parts = [first[d].to(device) if self.mesh.owner(d) == me
                 else torch.zeros(like.shape, dtype=like.dtype, device=device)
                 for d in range(self.mesh.dp)]
        out = torch.cat(parts, dim=0)
        dist.all_reduce(out)
        return out

    def forward(self, parts: list, tokens, positions, mask_positions, last_idx=None,
                slots: Optional[list] = None, embeds=None) -> torch.Tensor:
        """``llama.forward`` over the mesh: each shard runs its lanes of the
        step (``parts[d][r]`` its KV cache) and returns its row's gathered
        logits; returns [B, T, V] f32 (or [B, 1, V] with ``last_idx``) on the
        first local shard's device. ``slots``: each lane's first cache slot
        (-1 for a padded lane)."""
        n_lanes = len(slots)

        def cut(x, sl):
            return None if x is None else x[sl]

        def step(shard):
            sl = self.lanes(n_lanes, shard.d)
            kv = parts[shard.d][shard.r]
            li = cut(last_idx, sl)
            emb = cut(embeds, sl)
            logits = llama_model.forward(
                shard.cfg, shard.weights, cut(tokens, sl), cut(positions, sl), kv.k, kv.v,
                cut(mask_positions, sl), None, last_idx=li, slots=slots[sl],
                embeds=None if emb is None else emb.to(shard.device))
            return self.gather_logits(shard, logits)

        return self.rows(self.run(step), self.shards[0].device)

    def decode_scan(self, parts: list, first, pos0, n_steps: int):
        """``llama.decode_scan`` over the mesh: each shard greedy-decodes
        its lanes with its row's logits gathered before the argmax (2
        all-reduces a layer and 1 gather a step, nothing between rows).
        ``first``: [B] tokens; ``pos0``: [B] host ints. Returns (tokens [B,
        n_steps], first first; last [B]) on the first local shard's device."""
        first = torch.as_tensor(first)
        pos0 = np.asarray(pos0)

        def one(shard):
            sl = self.lanes(len(pos0), shard.d)
            part = parts[shard.d][shard.r]
            toks, last, _, _ = llama_model.decode_scan(
                shard.cfg, shard.weights, first[sl], pos0[sl], part.k, part.v, n_steps,
                logits_fixup=lambda lo: self.gather_logits(shard, lo))
            return torch.cat([toks, last[:, None]], dim=1)

        out = self.rows(self.run(one), self.shards[0].device)
        return out[:, :n_steps], out[:, n_steps]


def make_sharded_step(cfg: ModelConfig, mesh: Mesh):
    """The SPMD prefill / decode step over (dp, tp), as the JAX
    ``make_sharded_step``: make(weights) -> step(tokens [B, T], start_pos [B],
    kv) -> logits [B, T, V] f32, where ``kv`` is a ``ShardedKVCache`` over
    the same mesh (updated in place); lanes split over dp, heads and FFN
    over tp, the vocab gathered."""

    def make(weights):
        model = ShardedModel(cfg, weights, mesh)

        @torch.inference_mode()
        def step(tokens, start_pos, kv):
            tokens = np.asarray(tokens)
            start_pos = np.asarray(start_pos)
            toks, pos, mask, slots = step_inputs(tokens, start_pos, kv.max_seq)
            return model.forward(kv.parts, torch.from_numpy(toks), torch.from_numpy(pos),
                                 torch.from_numpy(mask), slots=slots)

        step.model = model
        return step

    return make


def make_sharded_scan(cfg: ModelConfig, mesh: Mesh, n_steps: int):
    """The SPMD greedy-decode scan over (dp, tp), as the JAX
    ``make_sharded_scan``: make(weights) -> scan(first [B], pos0 [B], kv) ->
    (tokens [B, n_steps], last [B]) (``ShardedModel.decode_scan``), where
    ``kv`` is a ``ShardedKVCache`` over the same mesh."""

    def make(weights):
        model = ShardedModel(cfg, weights, mesh)

        def scan(first, pos0, kv):
            return model.decode_scan(kv.parts, first, pos0, n_steps)

        scan.model = model
        return scan

    return make
