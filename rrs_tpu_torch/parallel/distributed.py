"""Multi-process entry: ``torch.distributed`` and the mesh from the CLI flags.

Port of ``rrs_tpu/parallel/distributed.py``. As in the JAX package every
process runs the same program (SPMD): each holds its share of the mesh's
shards and drives them, and the collectives of a dp row that spans processes
cross them through ``torch.distributed`` (``TPGroup`` in
``parallel/sharding.py``): NCCL for CUDA tensors, gloo for CPU tensors.

Flags (on generate / serve / bench):
  --tp N                  tensor-parallel ways (heads and FFN over shards)
  --dp N                  data-parallel ways over KV lanes
  --dist-coordinator H:P  the address process 0 listens on
  --dist-procs N          the process count
  --dist-id I             this process's index

The mesh's tp * dp shards split evenly over the processes, process-major:
process p holds shards p * k .. p * k + k - 1 (k = tp * dp / procs), on
``cuda:0 .. cuda:k-1``, or all on the CPU with ``--device cpu`` (the
counterpart of the JAX package's dry run on virtual CPU devices). The JAX
package's environment fallbacks (JAX_COORDINATOR_ADDRESS and the like) have
no counterpart here.
"""

from __future__ import annotations

from typing import Optional

import torch


def maybe_initialize(args) -> bool:
    """Join the process group named by ``--dist-coordinator`` / ``--dist-procs``
    / ``--dist-id`` (a no-op without a coordinator, or when joined already).
    Returns whether this process runs distributed."""
    coord = getattr(args, "dist_coordinator", None)
    if not coord:
        return False
    import torch.distributed as dist

    if not dist.is_initialized():
        nprocs = getattr(args, "dist_procs", None) or 1
        pid = getattr(args, "dist_id", None) or 0
        backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(backend, init_method=f"tcp://{coord}",
                                world_size=int(nprocs), rank=int(pid))
    return True


def mesh_from_args(args):
    """The (dp, tp) mesh of ``--tp`` / ``--dp`` over ``args.device``, or None
    for the single-device path. Raises SystemExit when this process's share
    of the shards needs more GPUs than it sees."""
    from rrs_tpu_torch.device import resolve_device
    from rrs_tpu_torch.parallel.sharding import Mesh

    tp = int(getattr(args, "tp", 1) or 1)
    dp = int(getattr(args, "dp", 1) or 1)
    dev = resolve_device(getattr(args, "device", None))
    if tp * dp <= 1:
        return None
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    me = dist.get_rank() if world > 1 else 0
    n = tp * dp
    if n % world:
        raise SystemExit(f"--tp {tp} --dp {dp}: {n} shards do not split over {world} processes")
    k = n // world
    if dev.type == "cuda":
        visible = torch.cuda.device_count()
        if visible < k:
            raise SystemExit(
                f"--tp {tp} --dp {dp} needs {k} devices in each of {world} process(es); "
                f"only {visible} visible. For a CPU dry run pass --device cpu.")
        local = [torch.device("cuda", i) for i in range(k)]
    else:
        local = [torch.device("cpu")] * k
    devices = [local[g % k] if g // k == me else None for g in range(n)]
    if world == 1:
        return Mesh(devices=devices, dp=dp)
    owners = tuple(g // k for g in range(n))
    groups = []
    for d in range(dp):
        procs = sorted(set(owners[d * tp:(d + 1) * tp]))
        if len(procs) == 1:
            groups.append(None)
        elif len(procs) == world:
            groups.append(dist.group.WORLD)
        else:
            # every process makes every group, in the same order
            groups.append(dist.new_group(procs))
    return Mesh(devices=devices, dp=dp, owners=owners, groups=tuple(groups))


def lanes_for(n_lanes: int, mesh: Optional[object]) -> int:
    """n_lanes rounded up to a multiple of the mesh's dp (lanes split evenly
    over the dp rows, rrs_tpu/__main__.py:378-380)."""
    if mesh is None:
        return n_lanes
    return -(-n_lanes // mesh.dp) * mesh.dp


def add_parallel_args(parser) -> None:
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel ways over the mesh's shards")
    parser.add_argument("--dp", type=int, default=1,
                        help="data-parallel ways over KV lanes")
    parser.add_argument("--dist-coordinator", default=None,
                        help="multi-process coordinator host:port (torch.distributed)")
    parser.add_argument("--dist-procs", type=int, default=None,
                        help="total process count")
    parser.add_argument("--dist-id", type=int, default=None,
                        help="this process's index")
