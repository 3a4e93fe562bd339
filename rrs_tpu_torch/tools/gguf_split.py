"""Shard / merge GGUF model files (tools/gguf-split analog), copied from
``rrs_tpu/tools/gguf_split.py``.

Split convention matches llama.cpp (llama-model-loader.cpp multi-split):
files named ``<base>-00001-of-00003.gguf`` with KVs ``split.no``,
``split.count``, ``split.tensors.count``; the first shard carries the full
model metadata, later shards only split bookkeeping + their tensors.
"""

from __future__ import annotations

import re
from pathlib import Path

from rrs_tpu_torch.gguf.reader import GGUFFile, read_gguf
from rrs_tpu_torch.gguf.writer import GGUFWriter

SPLIT_RE = re.compile(r"^(.*)-(\d{5})-of-(\d{5})\.gguf$")


def split_path(base: str | Path, i: int, n: int) -> Path:
    base = str(base)
    if base.endswith(".gguf"):
        base = base[: -len(".gguf")]
    return Path(f"{base}-{i + 1:05d}-of-{n:05d}.gguf")


def split_gguf(src: str | Path, dst_base: str | Path, n_split: int) -> list[Path]:
    """Split a GGUF into n_split shards (tensors round-robined by size)."""
    g = read_gguf(src)
    names = list(g.tensors)
    # greedy size balancing
    buckets: list[list[str]] = [[] for _ in range(n_split)]
    sizes = [0] * n_split
    for name in sorted(names, key=lambda t: -g.tensors[t].nbytes):
        i = sizes.index(min(sizes))
        buckets[i].append(name)
        sizes[i] += g.tensors[name].nbytes
    # preserve original order within each shard
    order = {n: i for i, n in enumerate(names)}
    out_paths = []
    total = len(names)
    for i, bucket in enumerate(buckets):
        bucket.sort(key=lambda t: order[t])
        path = split_path(dst_base, i, n_split)
        w = GGUFWriter(path)
        if i == 0:
            for k, v in g.metadata.items():
                w.add_kv(k, v, vtype=g.metadata_types.get(k))
        w.add_uint32("split.no", i)
        w.add_uint32("split.count", n_split)
        w.add_int32("split.tensors.count", total)
        for name in bucket:
            info = g.tensors[name]
            w.add_tensor(name, g.tensor_bytes(name).tobytes(),
                         shape=info.shape, ggml_type=info.ggml_type)
        w.write()
        out_paths.append(path)
    g.close()
    return out_paths


def merge_gguf(first_shard: str | Path, dst: str | Path) -> Path:
    """Merge shards back into one file."""
    shards = find_shards(first_shard)
    w = GGUFWriter(dst)
    readers = [read_gguf(p) for p in shards]
    for k, v in readers[0].metadata.items():
        if k.startswith("split."):
            continue
        w.add_kv(k, v, vtype=readers[0].metadata_types.get(k))
    for r in readers:
        for name, info in r.tensors.items():
            w.add_tensor(name, r.tensor_bytes(name).tobytes(),
                         shape=info.shape, ggml_type=info.ggml_type)
    w.write()
    for r in readers:
        r.close()
    return Path(dst)


def find_shards(path: str | Path) -> list[Path]:
    """Given any shard path (or a plain file), return all shard paths in order."""
    p = Path(path)
    m = SPLIT_RE.match(p.name)
    if not m:
        return [p]
    base, _, n = m.groups()
    return [p.parent / f"{base}-{i + 1:05d}-of-{int(n):05d}.gguf"
            for i in range(int(n))]


class MultiGGUF:
    """Read-only view over a set of shards with the GGUFFile interface subset
    used by the loader (metadata/tensors/tensor/tensor_bytes/close)."""

    def __init__(self, path: str | Path):
        self.files = [read_gguf(p) for p in find_shards(path)]
        self.metadata = dict(self.files[0].metadata)
        self.metadata_types = dict(self.files[0].metadata_types)
        self.tensors = {}
        self._owner: dict[str, GGUFFile] = {}
        for f in self.files:
            for name, info in f.tensors.items():
                self.tensors[name] = info
                self._owner[name] = f

    def tensor(self, name):
        return self._owner[name].tensor(name)

    def tensor_bytes(self, name):
        return self._owner[name].tensor_bytes(name)

    def close(self):
        for f in self.files:
            f.close()
