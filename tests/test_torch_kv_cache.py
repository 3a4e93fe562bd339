"""KV cache lanes of rrs_tpu_torch against rrs_tpu's, and the in-place store:
a lane with no token in a step parks its K/V rows at the top of its cache
(the last T slots of a T-row step) and leaves the live lane's logits as a
one-lane context computes them."""

import numpy as np
import torch

from rrs_tpu.runtime.kv_cache import KVCache as JaxKVCache
from rrs_tpu_torch.models import llama
from rrs_tpu_torch.runtime.context import InferenceContext
from rrs_tpu_torch.runtime.kv_cache import KVCache

from test_torch_common import jax_cfg, torch_cfg


def _ops(kv):
    """One script of lane operations; returns the lane state after each."""
    states = []
    for op, arg in [("new", 10), ("new", 11), ("len", (10, 7)), ("new", 12), ("new", 13),
                    ("len", (11, 9)), ("rm_tail", (11, 3)), ("rm_tail", (10, 8)), ("rm", 11),
                    ("new", 14), ("rm", 10), ("new", 15)]:
        if op == "new":
            try:
                kv.seq_new(arg)
            except RuntimeError as e:
                states.append(("error", str(e)))
                continue
        elif op == "len":
            kv.lengths[kv.lane_of(arg[0])] = arg[1]
        elif op == "rm_tail":
            kv.seq_rm(*arg)
        elif op == "rm":
            kv.seq_rm(arg)
        states.append((list(kv.seq_ids), list(kv.lengths), kv.lane_of(arg if op == "new" else arg[0])
                       if op != "rm" else None))
    return states


def test_lane_bookkeeping_matches_jax():
    jcfg = jax_cfg(n_layers=1)
    ref = _ops(JaxKVCache.create(jcfg, n_lanes=3, max_seq=32))
    got = _ops(KVCache.create(torch_cfg(jcfg), n_lanes=3, max_seq=32))
    assert got == ref


def test_idle_lane_parks_writes_at_top_slot():
    cfg = torch_cfg(jax_cfg())
    w = llama.random_weights(cfg, seed=3, quantize=True, device="cpu")
    one = InferenceContext(cfg, w, n_lanes=1, max_seq=64, device="cpu")
    two = InferenceContext(cfg, w, n_lanes=2, max_seq=64, device="cpu")
    prompt = [5, 9, 2, 77, 31]
    outs = []
    for ctx in (one, two):
        seq = ctx.new_sequence()
        pre = ctx.prefill(seq, prompt)
        dec = ctx.decode({seq: 8})[seq]
        outs.append((pre, dec))
    idle_k = two.kv.k[0][1].float()                      # lane 1: never given a token
    top = 64 - 16                                        # the prefill step's 16 rows
    assert idle_k[:, :top].abs().max().item() == 0.0     # only the top slots were written
    assert idle_k[:, top:].abs().amax(dim=(0, 2)).min().item() > 0.0
    live_k = two.kv.k[0][0].float()                      # the chunk's 16 rows, padding too
    assert live_k[:, 16:].abs().max().item() == 0.0
    # the live lane sees B=2 instead of B=1: same route, rows independent
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-5)
        assert int(torch.argmax(a[-1])) == int(torch.argmax(b[-1]))


def _serving_ops(kv):
    """The lane operations of the serving engine: retention with LRU
    eviction, has_seq, seq_cp, seq_keep, lengths_array."""
    states = []
    for s, n in ((1, 5), (2, 7), (3, 2)):
        kv.seq_new(s)
        kv.lengths[kv.lane_of(s)] = n
    kv.mark_retained(2)
    kv.mark_retained(1)                 # 2 is the least recently retained
    kv.seq_new(4)                       # no free lane: evicts 2
    states.append((list(kv.seq_ids), [kv.has_seq(s) for s in (1, 2, 3, 4)],
                   sorted(kv.retained)))
    kv.unmark_retained(1)
    kv.seq_rm(4)
    kv.seq_cp(1, 5)                     # into the freed lane
    states.append((list(kv.seq_ids), list(kv.lengths)))
    kv.seq_keep(5)
    states.append((list(kv.seq_ids), list(kv.lengths), sorted(kv.retained),
                   [int(x) for x in np.asarray(kv.lengths_array())]))
    return states


def test_serving_lane_ops_match_jax():
    jcfg = jax_cfg(n_layers=1)
    ref = _serving_ops(JaxKVCache.create(jcfg, n_lanes=3, max_seq=16))
    kv = KVCache.create(torch_cfg(jcfg), n_lanes=3, max_seq=16)
    kv.k[0][0] = torch.randn(kv.k[0][0].shape).to(kv.k[0].dtype)   # lane 0 holds seq 1
    lane0 = kv.k[0][0].clone()
    got = _serving_ops(kv)
    assert got == ref
    # seq_cp copied the whole lane in place
    assert torch.equal(kv.k[0][kv.lane_of(5)], lane0)
