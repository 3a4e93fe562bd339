"""Training / finetuning: port of ``rrs_tpu/train/finetune.py``.

The JAX package takes ``jax.value_and_grad`` of the mean next-token
cross-entropy and steps optax's AdamW or SGD over a token stream chunked into
(input, target) blocks. Here autograd takes the gradient and the optimizer is
the port's own, with optax's arithmetic (``Optimizer``).

Every f32 / bf16 / f16 tensor of the weights trains, as JAX's ``partition``
decides: TCQ4's bf16 group scales ``eff`` and the f32 superblock scales of
the i8p pack too, which get a zero gradient (the straight-through backward of
``models/linear.py`` gives them none) and so move only under weight decay.
Integer tensors (TCQ4 / Q8 codes, the i8p codes, a channel permutation) are
frozen and shared with the caller's weights; trained tensors are copies, so
the caller's weights are left as they were.

The forward runs with ``ref_attention`` (the plain attention on the card too,
as JAX's training does: the flash kernels have no backward) over bf16 scratch
caches. TCQ4 linears run the W4A4 kernels forward and the straight-through
backward; the Q8 head runs B2 forward and JAX's CPU gradient (dx and the
scales'). Packed expert stacks and TCQ4 linears with a channel permutation
raise NotImplementedError under autograd, as ``jax.grad`` fails there.

Entry points run on ``cuda`` unless given ``device="cpu"``, and raise
without a GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from rrs_tpu_torch.device import resolve_device, set_matmul_precision
from rrs_tpu_torch.models import llama as llama_model
from rrs_tpu_torch.models.config import ModelConfig

FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@dataclasses.dataclass
class TrainConfig:
    optimizer: str = "adamw"        # "adamw" | "sgd" (the two ggml-opt offers)
    lr: float = 1e-4
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    clip_norm: float = 0.0


def make_dataset(tokens: list[int], seq_len: int, batch: int = 1,
                 seed: int = 0) -> list[np.ndarray]:
    """Chunk a token stream into [batch, seq_len+1] int32 blocks (inputs and
    shifted labels in one array), in the order of the JAX package's
    ``default_rng(seed).permutation``: the same batches, bit for bit."""
    n = (len(tokens) - 1) // seq_len
    rng = np.random.default_rng(seed)
    starts = rng.permutation(n) * seq_len
    blocks = [np.asarray(tokens[s: s + seq_len + 1], np.int64)
              for s in starts if s + seq_len + 1 <= len(tokens)]
    out = []
    for i in range(0, len(blocks) - batch + 1, batch):
        out.append(np.stack(blocks[i: i + batch]).astype(np.int32))
    return out


def _loss_fn(cfg: ModelConfig, weights, batch, logits_sharding=None) -> torch.Tensor:
    """Mean next-token cross-entropy over a [B, T+1] batch: the forward over
    bf16 scratch caches with the plain attention, the log-softmax in f32.
    ``logits_sharding`` (a shard of ``parallel/train_step.py``'s mesh, the
    JAX argument's counterpart): logits -> (its dp row's whole logits, the
    positions this shard scores, the token count of the global batch); the
    shard returns its positions' share of the global mean (sp-over-tp)."""
    cfg = dataclasses.replace(cfg, ref_attention=True)
    dev = weights.device
    batch = torch.as_tensor(np.asarray(batch), dtype=torch.int64).to(dev)
    toks, labels = batch[:, :-1], batch[:, 1:]
    b, t = toks.shape
    pos = torch.arange(t, dtype=torch.int32, device=dev)[None, :].expand(b, t)
    kc, vc = llama_model.scratch_caches(cfg, b, t, device=dev)
    logits = llama_model.forward(cfg, weights, toks, pos, kc, vc, pos, None, slots=[0] * b)
    if logits_sharding is None:
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        return -logp.gather(-1, labels[..., None])[..., 0].mean()
    logits, part, count = logits_sharding(logits)
    logp = torch.log_softmax(logits[:, part].to(torch.float32), dim=-1)
    return -logp.gather(-1, labels[:, part, None])[..., 0].sum() / count


def _tree_map(fn, *trees):
    """``fn`` over the leaves of parallel weight trees (dataclasses, lists,
    tuples, dicts; anything else, None included, is a leaf)."""
    t0 = trees[0]
    if dataclasses.is_dataclass(t0) and not isinstance(t0, type):
        return dataclasses.replace(t0, **{
            f.name: _tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0)})
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    return fn(*trees)


def _leaves(tree) -> list:
    """The tensors of a tree, in a fixed order."""
    out = []
    _tree_map(lambda x: out.append(x) if isinstance(x, torch.Tensor) else None, tree)
    return out


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.dtype in FLOAT_DTYPES


def partition(weights):
    """Split into (params, static): float tensors train, everything else
    (integer codes, ints, strings) is frozen. Both trees keep the structure,
    with None in the complementary slots; the tensors are the caller's."""
    params = _tree_map(lambda w: w if _is_float(w) else None, weights)
    static = _tree_map(lambda w: None if _is_float(w) else w, weights)
    return params, static


def combine(params, static):
    return _tree_map(lambda p, s: p if s is None else s, params, static)


def trainable(weights):
    """(params, static, leaves): ``partition`` with each trained tensor a
    fresh leaf copy that requires grad, and those leaves in a fixed order.
    JAX's parameters are separate arrays, so a tied head (a view of the
    embedding here) becomes a leaf of its own."""
    params, static = partition(weights)
    params = _tree_map(lambda p: None if p is None else p.detach().clone().requires_grad_(True),
                       params)
    return params, static, _leaves(params)


def _as_dtype(v: float, dtype) -> float:
    """A Python scalar rounded to ``dtype`` first, as JAX rounds a weak-typed
    scalar to the array's dtype before the operation."""
    return v if dtype == torch.float32 else float(torch.tensor(v, dtype=dtype))


class Optimizer:
    """``optax.adamw`` or ``optax.sgd`` (after ``optax.clip_by_global_norm``
    when ``clip_norm`` > 0) with optax's arithmetic, one operation at a time:

      mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
      u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p
      p = p - lr u                                   (SGD: p = p - lr g)

    with ``eps`` outside the square root, the bias corrections in f32 cast
    to each moment's dtype, decoupled decay over every parameter, and the
    state in each parameter's dtype. Clipping scales every gradient by
    max / norm where the global norm sqrt(sum of sum(g^2) over the leaves) is
    not below max (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``). A
    parameter without a gradient (TCQ4's scales) takes a zero one; its
    moments stay unallocated while they are zero."""

    def __init__(self, tc: TrainConfig):
        if tc.optimizer not in ("adamw", "sgd"):
            raise ValueError(f"unknown optimizer {tc.optimizer!r}")
        self.tc = tc
        self.count = 0
        self.mu: dict = {}                  # parameter index -> first moment
        self.nu: dict = {}

    def _clip(self, grads: list, sq=None) -> list:
        if sq is None:
            sq = sum(torch.sum(g * g) for g in grads if g is not None)
        if not isinstance(sq, torch.Tensor):
            return grads
        norm = torch.sqrt(sq)
        clip = self.tc.clip_norm
        return [None if g is None else torch.where(
            norm.to(g.device) < clip, g,
            (g / norm.to(g.device, g.dtype)) * _as_dtype(clip, g.dtype)) for g in grads]

    @torch.no_grad()
    def step(self, params: list, grads: list, sq_norm=None) -> None:
        """Update ``params`` in place from ``grads`` (None: no gradient).
        ``sq_norm``: the squared global norm the clip divides by, where the
        parameters are shards of a larger model (``parallel/train_step.py``);
        by default the sum over ``grads``."""
        tc = self.tc
        grads = [None if g is None else g.to(p.dtype) for p, g in zip(params, grads)]
        if tc.clip_norm > 0:
            grads = self._clip(grads, sq_norm)
        if tc.optimizer == "sgd":
            for p, g in zip(params, grads):
                if g is not None:
                    p.add_(g * _as_dtype(-tc.lr, p.dtype))
            return
        self.count += 1
        bc1 = float(np.float32(1) - np.float32(tc.beta1) ** np.int32(self.count))
        bc2 = float(np.float32(1) - np.float32(tc.beta2) ** np.int32(self.count))
        for i, (p, g) in enumerate(zip(params, grads)):
            dt = p.dtype
            if g is None and i not in self.mu:
                if not tc.weight_decay:
                    continue                         # p - lr * 0 / (sqrt(0) + eps)
                u = torch.zeros_like(p)
            else:
                if g is None:
                    g = torch.zeros_like(p)
                if i not in self.mu:
                    self.mu[i], self.nu[i] = torch.zeros_like(p), torch.zeros_like(p)
                mu, nu = self.mu[i], self.nu[i]
                mu.mul_(_as_dtype(tc.beta1, dt)).add_(g * _as_dtype(1 - tc.beta1, dt))
                nu.mul_(_as_dtype(tc.beta2, dt)).add_(
                    torch.square(g).mul_(_as_dtype(1 - tc.beta2, dt)))
                # divided by a tensor: on the card a division by a Python
                # scalar multiplies by its reciprocal (ROADMAP queue C)
                c1 = torch.full((), bc1, dtype=dt, device=p.device)
                c2 = torch.full((), bc2, dtype=dt, device=p.device)
                u = (mu / c1).div_(torch.sqrt(nu / c2).add_(_as_dtype(tc.eps, dt)))
            if tc.weight_decay:
                u.add_(p * _as_dtype(tc.weight_decay, dt))
            p.add_(u.mul_(_as_dtype(-tc.lr, dt)))


def make_optimizer(tc: TrainConfig) -> Optimizer:
    return Optimizer(tc)


def train(
    cfg: ModelConfig,
    weights,
    batches: Iterable[np.ndarray],
    tc: Optional[TrainConfig] = None,
    n_epochs: int = 1,
    on_step: Optional[Callable[[int, float], None]] = None,
    chunk_steps: int = 1,
    device=None,
):
    """Finetune on ``device`` (``None`` = cuda; the weights are moved there
    if they live elsewhere); returns (weights, losses), the trained floats as
    new tensors and the frozen ones shared. ``chunk_steps`` > 1 reads the
    losses back once per that many steps (the JAX package's device-side
    ``lax.scan``); the steps are the loop's."""
    dev = resolve_device(device)
    set_matmul_precision()
    tc = tc or TrainConfig()
    if weights.device != dev:
        weights = llama_model.to_device(weights, dev)
    params, static, plist = trainable(weights)
    opt = make_optimizer(tc)

    def one_step(batch) -> torch.Tensor:
        for p in plist:
            p.grad = None
        loss = _loss_fn(cfg, combine(params, static), batch)
        loss.backward()
        opt.step(plist, [p.grad for p in plist])
        return loss.detach()

    losses: list[float] = []

    def record(vals) -> None:
        for loss in vals:
            losses.append(loss)
            if on_step:
                on_step(len(losses) - 1, loss)

    for _ in range(n_epochs):
        if chunk_steps > 1:
            blist = list(batches)
            for c0 in range(0, len(blist), chunk_steps):
                ls = [one_step(b) for b in blist[c0:c0 + chunk_steps]]
                record(torch.stack(ls).tolist())
            continue
        for batch in batches:
            record([float(one_step(batch))])
    for p in plist:
        p.grad = None
    return combine(_tree_map(lambda p: None if p is None else p.detach(), params), static), \
        losses


@torch.no_grad()
def evaluate(cfg: ModelConfig, weights, batches, device=None) -> float:
    """Mean loss over batches on ``device`` (``None`` = cuda)."""
    dev = resolve_device(device)
    set_matmul_precision()
    if weights.device != dev:
        weights = llama_model.to_device(weights, dev)
    vals = [float(_loss_fn(cfg, weights, b)) for b in batches]
    return float(np.mean(vals)) if vals else float("nan")
