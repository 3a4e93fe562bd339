"""The multi-process entry of rrs_tpu_torch (``parallel/distributed.py``)
against the JAX package's single-process reference of tests/test_multihost.py.

Two OS processes, each with two CPU shards of a tp = 4 mesh, join one gloo
process group through ``--dist-coordinator`` / ``--dist-procs`` /
``--dist-id`` (``maybe_initialize``, then ``mesh_from_args``); each runs the
same TP ``InferenceContext`` prefill and greedy decode, its row-parallel
sums and logits gathers crossing the processes. Both must print the greedy
tokens of the JAX package's single-device context on the same weights. The
worker is this file run as a script:

    python tests/test_torch_multihost.py <pid> <nprocs> <port> <tp>
"""

import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
PROMPT = [1, 2, 3, 4, 5]
CFG = dict(arch="qwen3", n_layers=2, n_embd=256, n_heads=8, n_kv_heads=4, head_dim=128,
           n_ff=1024, vocab_size=512, context_length=128, qk_norm=True)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_tp_matches_jax_single_process():
    import numpy as np

    nprocs, tp = 2, 4
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, __file__, str(pid), str(nprocs), str(port), str(tp)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=str(ROOT), env=env)
             for pid in range(nprocs)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err[-4000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    lines = [ln for out in outs for ln in out.splitlines() if ln.startswith("TOKENS:")]
    assert len(lines) == nprocs and len(set(lines)) == 1, lines
    got = [int(t) for t in lines[0].split(":", 1)[1].split(",")]

    from rrs_tpu.models import llama as jllama
    from rrs_tpu.models.config import ModelConfig
    from rrs_tpu.runtime.context import InferenceContext

    ref = InferenceContext(ModelConfig(**CFG),
                           jllama.random_weights(ModelConfig(**CFG), seed=3, quantize=True),
                           n_lanes=1, max_seq=64)
    seq = ref.new_sequence()
    want = [int(np.asarray(ref.prefill(seq, PROMPT)[-1]).argmax())]
    for _ in range(4):
        want.append(int(np.asarray(ref.decode({seq: want[-1]})[seq]).argmax()))
    assert got == want


def _worker(pid: int, nprocs: int, port: int, tp: int) -> None:
    import torch
    import torch.distributed as dist

    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.parallel.distributed import maybe_initialize, mesh_from_args
    from rrs_tpu_torch.runtime.context import InferenceContext

    torch.set_num_threads(1)
    args = SimpleNamespace(dist_coordinator=f"127.0.0.1:{port}", dist_procs=nprocs,
                           dist_id=pid, tp=tp, dp=1, device="cpu")
    assert maybe_initialize(args), "the distributed flags must join the group"
    assert dist.get_world_size() == nprocs and dist.get_rank() == pid
    mesh = mesh_from_args(args)
    assert mesh.shape == {"dp": 1, "tp": tp} and len(mesh.local()) == tp // nprocs
    cfg = ModelConfig(**CFG)
    # the JAX package's random_weights draws, bit for bit
    ctx = InferenceContext(cfg, llama.random_weights(cfg, seed=3, quantize=True, device="cpu"),
                           n_lanes=1, max_seq=64, mesh=mesh)
    seq = ctx.new_sequence()
    toks = [int(ctx.prefill(seq, PROMPT)[-1].argmax())]
    for _ in range(4):
        toks.append(int(ctx.decode({seq: toks[-1]})[seq].argmax()))
    print("TOKENS:" + ",".join(str(t) for t in toks), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(*(int(v) for v in sys.argv[1:5]))
