"""rrs_tpu_torch/parallel/sharding.py against rrs_tpu/parallel/sharding.py.

The same NumPy-made weights go through both packages' plans on a (dp, tp)
mesh: the JAX package's on the conftest's 8 virtual CPU devices, the port's
on 8 CPU shards. Every leaf of the port's shard (d, r) must equal the data
JAX's sharded array holds at the same mesh position, bit for bit (a
column-parallel channel permutation excepted, which the port keeps whole:
ROADMAP queue C). The sharded step and the greedy scan are held to JAX's
(compiled without XLA's excess precision, ``exact_jit``), the collectives
of a decode step are counted, and JAX's refusals are kept."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from rrs_tpu.models import llama as jllama
from rrs_tpu.models.config import ModelConfig as JaxConfig
from rrs_tpu.models.linear import (DenseLinear as JDense, MXFP4Linear as JMX, Q8Linear as JQ8,
                                   TCQ4Linear as JTCQ4)
from rrs_tpu.parallel import sharding as jsh
from rrs_tpu_torch.models.llama import weights_from_numpy
from rrs_tpu_torch.parallel import sharding as tsh
from rrs_tpu_torch.runtime.kv_cache import ShardedKVCache

from test_torch_common import exact_jit, torch_cfg, weights_tree

CPU8 = ["cpu"] * 8


def _qwen3(**over):
    # row-parallel local K (heads * head_dim / tp, n_ff / tp) stays 256-aligned at tp = 4
    return JaxConfig(**{**dict(arch="qwen3", n_layers=2, n_embd=256, n_heads=8, n_kv_heads=4,
                               head_dim=128, n_ff=1024, vocab_size=512, context_length=128,
                               qk_norm=True), **over})


def _port(cfg, w):
    return torch_cfg(cfg), weights_from_numpy(torch_cfg(cfg), weights_tree(w), device="cpu")


def _sink_weights():
    """One JAX model holding every kind of leaf the plan splits: TCQ4 with a
    channel permutation and the i8p pack (column- and row-parallel), Q8,
    MXFP4, dense with biases, gpt-oss sinks, MLA's latent projections and
    head factors, a dense MoE layer with expert biases and a shared expert, a
    packed one, a Q8 embedding table and a Q8 lm_head of a padded vocab."""
    from rrs_tpu.formats.kquants import quantize_mxfp4
    from rrs_tpu.formats.tcq4 import quantize_tcq4
    from rrs_tpu.models.moe import MoEWeights
    from rrs_tpu.ops.tcq4_matmul import pack_i8p

    rng = np.random.default_rng(0)
    e, h, d, f, v = 256, 8, 128, 1024, 500

    def normal(*shape, dt=jnp.float32):
        return jnp.asarray(rng.standard_normal(shape) * 0.02, dt)

    def tcq4(k, n, perm=False, i8p=False):
        p = np.concatenate([rng.permutation(256) + 256 * b for b in range(k // 256)]) \
            if perm else None
        lin = JTCQ4.from_tensor(quantize_tcq4(np.asarray(normal(n, k)), perm=p))
        return dataclasses.replace(lin, i8p=tuple(pack_i8p(lin.qs, lin.eff))) if i8p else lin

    def mxfp4(k, n):
        return JMX.from_gguf(quantize_mxfp4(np.asarray(normal(n, k))), (n, k))

    layer0 = jllama.LayerWeights(
        attn_norm=jnp.ones((e,)), wq=tcq4(e, h * d, perm=True, i8p=True),
        wk=JQ8.quantize(np.asarray(normal(512, e))), wv=mxfp4(e, 512),
        wo=tcq4(h * d, e, perm=True, i8p=True), q_norm=jnp.ones((d,)), k_norm=jnp.ones((d,)),
        ffn_norm=jnp.ones((e,)), w_gate=JDense(w=normal(e, f), bias=normal(f)),
        w_up=mxfp4(e, f), w_down=JQ8.quantize(np.asarray(normal(e, f))),
        attn_sinks=normal(h))
    n_exp, fe = 4, 64
    dense_moe = MoEWeights(
        router=normal(e, n_exp, dt=jnp.bfloat16), gate=normal(n_exp, e, fe, dt=jnp.bfloat16),
        up=normal(n_exp, e, fe, dt=jnp.bfloat16), down=normal(n_exp, fe, e, dt=jnp.bfloat16),
        gate_b=normal(n_exp, fe), up_b=normal(n_exp, fe), down_b=normal(n_exp, e),
        shared_gate=normal(e, 128, dt=jnp.bfloat16), shared_up=normal(e, 128, dt=jnp.bfloat16),
        shared_down=normal(128, e, dt=jnp.bfloat16))
    layer1 = jllama.LayerWeights(
        attn_norm=jnp.ones((e,)), wq=tcq4(e, h * d), wk=None, wv=None,
        wo=JDense(w=normal(h * d, e), bias=normal(e)), q_norm=jnp.ones((64,)),
        k_norm=jnp.ones((64,)), ffn_norm=jnp.ones((e,)), w_gate=None, w_up=None, w_down=None,
        moe=dense_moe, wq_a=JDense(w=normal(e, 64)), wkv_a=JDense(w=normal(e, 80)),
        wk_b=normal(h, 16, 64, dt=jnp.bfloat16), wv_b=normal(h, 64, 32, dt=jnp.bfloat16))
    u8 = lambda *shape: jnp.asarray(rng.integers(0, 256, shape), jnp.uint8)   # noqa: E731
    packed = MoEWeights(
        router=normal(e, n_exp), gate=None, up=None, down=None, gate_qs=u8(n_exp, e // 2, fe),
        up_qs=u8(n_exp, e // 2, fe),
        down_qs=u8(n_exp, fe // 2, e), gate_eff=normal(n_exp, e // 32, fe, dt=jnp.bfloat16),
        up_eff=normal(n_exp, e // 32, fe, dt=jnp.bfloat16),
        down_eff=normal(n_exp, fe // 32, e, dt=jnp.bfloat16), gate_b=normal(n_exp, fe),
        up_b=normal(n_exp, fe), down_b=normal(n_exp, e))
    layer2 = jllama.LayerWeights(
        attn_norm=jnp.ones((e,)), wq=tcq4(e, h * d), wk=tcq4(e, 512), wv=tcq4(e, 512),
        wo=tcq4(h * d, e), q_norm=None, k_norm=None, ffn_norm=jnp.ones((e,)), w_gate=None,
        w_up=None, w_down=None, moe=packed)
    embed = (jnp.asarray(rng.integers(-127, 128, (v, e)), jnp.int8), normal(v, e // 32))
    w = jllama.ModelWeights(embed=embed, layers=[layer0, layer1, layer2],
                            final_norm=jnp.ones((e,)),
                            lm_head=JQ8.quantize(np.asarray(normal(v, e))))
    assert w.lm_head.n_logical == v and w.lm_head.q.shape[1] == 512
    return _qwen3(n_layers=3, vocab_size=v), w


def _leaves(obj, path=""):
    """(path, array) for every array leaf of a weights tree of either package."""
    if obj is None or isinstance(obj, (str, int, float)):
        return
    if isinstance(obj, (torch.Tensor, jax.Array)):
        yield path, obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, (list, tuple)):
        for i, o in enumerate(obj):
            yield from _leaves(o, f"{path}[{i}]")


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_every_leaf_equals_jax_shard_bit_for_bit():
    cfg, jw = _sink_weights()
    jmesh = jsh.make_mesh(8, dp=2)
    jws = jsh.shard_weights(jw, jmesh)
    _, tw = _port(cfg, jw)
    mesh = tsh.make_mesh(devices=CPU8, dp=2)
    tws = tsh.shard_weights(tw, mesh)
    jleaves = dict(_leaves(jws))
    full = dict(_leaves(jw))
    n = 0
    for d, r in mesh.local():
        mine = dict(_leaves(tws[d * mesh.tp + r]))
        assert set(mine) == set(jleaves), set(mine) ^ set(jleaves)
        dev = jmesh.devices[d, r]
        for path, arr in jleaves.items():
            want = next(np.asarray(s.data) for s in arr.addressable_shards if s.device == dev)
            if path == ".layers[0].wq.gather":
                # column-parallel: the port keeps the permutation whole
                want = np.asarray(full[path])
            got = _bits(mine[path])
            want = want.view(np.int16) if want.dtype.name == "bfloat16" else want
            assert got.shape == want.shape, (path, got.shape, want.shape)
            if got.dtype != want.dtype:              # int32 vs int64 permutation offsets
                np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=path)
            else:
                assert got.tobytes() == want.tobytes(), path
            n += 1
    assert n == 8 * len(jleaves)
    # the padded vocab is cut after the gather, never per shard
    assert tws[1].lm_head.n_logical == 0 and tw.lm_head.n_logical == 500
    # shards of one tp rank on one device share their tensors
    assert tws[1].layers[0].wq.qs is tws[5].layers[0].wq.qs


def _jax_step(cfg, w, mesh, tokens, start, s, dtype):
    shape = (tokens.shape[0], cfg.n_kv_heads, s, cfg.head_dim)
    spec = NamedSharding(mesh, P("dp", "tp", None, None))
    ks = [jax.device_put(jnp.zeros(shape, dtype), spec) for _ in range(cfg.n_layers)]
    vs = [jax.device_put(jnp.zeros(shape, dtype), spec) for _ in range(cfg.n_layers)]
    ws = jsh.shard_weights(w, mesh)
    with exact_jit():
        logits, _, _ = jsh.make_sharded_step(cfg, mesh)(ws)(
            ws, jnp.asarray(tokens), jnp.asarray(start), ks, vs)
    return np.asarray(logits)


@pytest.mark.parametrize("case", ["qwen3", "gemma_swa"])
def test_sharded_step_matches_jax(case):
    if case == "qwen3":
        cfg = _qwen3()
        w = jllama.random_weights(cfg, seed=3, quantize=True)
        dp, n, dtype, tok = 2, 8, jnp.bfloat16, [[1, 2, 3], [4, 5, 6]]
        tol = 3e-2
    else:
        cfg = JaxConfig(
            arch="gemma3", n_layers=2, n_embd=128, n_heads=8, n_kv_heads=4, head_dim=32,
            n_ff=256, vocab_size=128, context_length=128, qk_norm=True, swa_window=8,
            swa_pattern=2, rope_theta_swa=10000.0, ffn_act="gelu", embd_scale=128.0 ** 0.5,
            sandwich_norm=True, attn_softcap=50.0, final_softcap=30.0)
        w = jllama.random_weights(cfg, seed=0, dtype=jnp.float32)
        dp, n, dtype, tok = 1, 4, jnp.float32, [[1, 2, 3, 4], [5, 6, 7, 8]]
        tol = 2e-3
    tokens = np.asarray(tok, np.int32)
    start = np.zeros((2,), np.int32)
    want = _jax_step(cfg, w, jsh.make_mesh(n, dp=dp), tokens, start, 32, dtype)
    tcfg, tw = _port(cfg, w)
    mesh = tsh.make_mesh(devices=["cpu"] * n, dp=dp)
    step = tsh.make_sharded_step(tcfg, mesh)(tw)
    kv = ShardedKVCache.create_sharded(tcfg, 2, 32, mesh,
                                       dtype=torch.float32 if case != "qwen3" else torch.bfloat16)
    got = step(tokens, start, kv).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_sharded_scan_and_collective_schedule():
    """make_sharded_scan's greedy tokens are JAX's; one decode step runs 2
    all-reduces a layer (o, down; [1, 1, E] f32 from each shard) and 1
    logits gather in each dp row, and nothing between rows."""
    cfg = _qwen3()
    w = jllama.random_weights(cfg, seed=3, quantize=True)
    jmesh = jsh.make_mesh(4, dp=2)
    ws = jsh.shard_weights(w, jmesh)
    spec = NamedSharding(jmesh, P("dp", "tp", None, None))
    shape = (2, cfg.n_kv_heads, 16, cfg.head_dim)
    ks = [jax.device_put(jnp.zeros(shape, jnp.bfloat16), spec) for _ in range(2)]
    vs = [jax.device_put(jnp.zeros(shape, jnp.bfloat16), spec) for _ in range(2)]
    first, pos0 = np.asarray([3, 7], np.int32), np.asarray([0, 0], np.int32)
    with exact_jit():
        jt, jlast = jsh.make_sharded_scan(cfg, jmesh, 4)(ws)(
            ws, jnp.asarray(first), jnp.asarray(pos0), ks, vs)
    tcfg, tw = _port(cfg, w)
    mesh = tsh.make_mesh(devices=["cpu"] * 4, dp=2)
    scan = tsh.make_sharded_scan(tcfg, mesh, 4)(tw)
    toks, last = scan(first, pos0, ShardedKVCache.create_sharded(tcfg, 2, 16, mesh))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))

    step = tsh.make_sharded_step(tcfg, mesh)(tw)
    kv = ShardedKVCache.create_sharded(tcfg, 2, 16, mesh)
    step(np.asarray([[3], [7]]), np.asarray([0, 0]), kv)
    groups = step.model.groups
    assert sorted(groups) == [0, 1]
    for g in groups.values():
        assert g.counts == {"all_reduce": 2 * cfg.n_layers, "all_gather": 1}, g.counts
        assert g.bytes["all_reduce"] == 2 * cfg.n_layers * cfg.n_embd * 4
        assert g.dist_group is None
    assert not torch.distributed.is_initialized()


def test_refusals_kept():
    cfg = _qwen3(n_layers=1)
    tcfg = torch_cfg(cfg)
    mesh4 = tsh.make_mesh(devices=["cpu"] * 4)
    # fused projections
    jw = jllama.random_weights(cfg, seed=1, quantize=True)
    _, tw = _port(cfg, jw)
    fused = dataclasses.replace(tw, layers=[dataclasses.replace(
        tw.layers[0], w_gateup=tw.layers[0].w_gate, w_gate=None)])
    with pytest.raises(ValueError, match="fused projections"):
        tsh.shard_weights(fused, mesh4)
    # a K-padded Q8 cannot be row-sharded; an N-padded MXFP4 cannot be column-sharded
    from rrs_tpu_torch.models.linear import MXFP4Linear, Q8Linear

    q8 = Q8Linear.quantize(np.ones((256, 288), np.float32))
    assert q8.k_logical == 288
    with pytest.raises(ValueError, match="K-padded Q8Linear"):
        tsh._linear_shard(q8, False, 0, 4)
    tsh._linear_shard(q8, True, 0, 4)
    mx = MXFP4Linear(qs=torch.zeros((128, 512), dtype=torch.uint8),
                     scale=torch.zeros((8, 512), dtype=torch.uint8), n_logical=500)
    with pytest.raises(ValueError, match="N-padded MXFP4Linear"):
        tsh._linear_shard(mx, True, 0, 4)
    # heads and kv heads over tp
    with pytest.raises(ValueError, match="heads 8 not divisible by tp=3"):
        tsh._local_cfg(tcfg, 3)
    with pytest.raises(ValueError, match="kv heads 4 not divisible by tp=8"):
        tsh._local_cfg(tcfg, 8)
    # row-parallel TCQ4 shards stay 256-aligned: n_ff 1536 at tp 4 gives 384
    c2 = _qwen3(n_layers=1, n_ff=1536)
    _, tw2 = _port(c2, jllama.random_weights(c2, seed=2, quantize=True))
    with pytest.raises(ValueError, match="TCQ4 activation width 384 not a multiple of 256; "
                                         "for row-parallel TP shards"):
        tsh.shard_weights(tw2, mesh4)
    with pytest.raises(ValueError, match="do not split into dp=3"):
        tsh.make_mesh(devices=["cpu"] * 4, dp=3)


def test_shard_error_aborts_every_shard():
    """A shard that raises breaks the barrier for the others (no hang); the
    shard's own error comes back, and the model runs again afterwards."""
    cfg = _qwen3(n_layers=1)
    tcfg, tw = _port(cfg, jllama.random_weights(cfg, seed=1, quantize=True))
    model = tsh.ShardedModel(tcfg, tw, tsh.make_mesh(devices=["cpu"] * 4, dp=2))

    def fn(shard):
        if (shard.d, shard.r) == (1, 1):
            raise KeyError("shard (1, 1)")
        return shard.cfg.tp_axis.all_reduce(torch.ones(2))

    with pytest.raises(KeyError, match="shard"):
        model.run(fn)
    out = model.run(lambda sh: sh.cfg.tp_axis.all_reduce(torch.full((2,), float(sh.r + 1))))
    assert [o.tolist() for o in out] == [[3.0, 3.0]] * 4
