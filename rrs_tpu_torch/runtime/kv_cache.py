"""KV cache: preallocated device tensors plus host-side lane bookkeeping.

Port of ``rrs_tpu/runtime/kv_cache.py``: per-layer [B, Hkv, S_l, D] caches
(kv-head-major; an MLA model caches one head of [k_pe | c_kv] rows for K and
c_kv rows for V, ``cfg.kv_cache_heads`` / ``kv_k_dim`` / ``kv_v_dim``),
where a sliding-window layer holds a ring of ``round_up(window + max_chunk,
128)`` slots (at most max_seq) and every other layer max_seq, bf16 or
quantized (``quant="q8"`` or ``"q4"``: a ``(codes, f32 scales)`` tuple per layer in the layouts of
``runtime/kv_codec.py``; q4 takes the head-pair layout for an even kv-head
count and the halves layout for an odd one), one sequence per batch lane, and
the lane operations the engine uses: ``seq_new`` with LRU eviction of retained
prompt caches, ``mark_retained`` / ``unmark_retained``, ``has_seq``,
``seq_rm``, ``seq_cp`` (whole lanes, right for rings too), ``seq_keep``,
``lengths_array`` and the context shift ``seq_shift``, which raises for a
model with sliding layers, as the JAX package's does, and re-rotates only the
leading ``qk_rope_dim`` dims of an MLA row. The forward writes new
rows into these tensors in place, and ``seq_cp`` / ``seq_shift`` / ``seq_div``
update them in place too.

The position rows: a lane's RoPE positions are its slots unless ``seq_div``
(self-extend) remapped them (``slot_pos``) or a Qwen2-VL image chunk left an
M-RoPE text-position delta (``mrope_delta``, set by ``mrope_begin_image``);
``positions_row`` / ``pos_offset`` read them for the context's ``pos_row``
feed. The causal mask and the ring slots stay slot-derived.

Under tensor / data parallelism (``parallel/sharding.py``) a
``ShardedKVCache`` keeps the lane state once and a (dp, tp) grid of caches,
one a shard (``create(tp=)``: the local kv heads; an MLA latent row stays
whole on every tp shard), each holding its dp row's lanes on the shard's
device. The lane operations reach every shard of the lane's row.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from rrs_tpu_torch.models.config import ModelConfig


@dataclasses.dataclass
class KVCache:
    """Per-layer K/V device tensors plus host-side lane state."""

    k: list                       # L x [B, Hkv, S, D], or L x (codes, scales)
    v: list
    max_seq: int
    lengths: list                 # tokens currently stored per lane
    seq_ids: list                 # sequence occupying each lane (None = free)
    sizes: list = dataclasses.field(default_factory=list)   # slots per layer (rings smaller)
    # seq_id -> retention time: lanes kept as prompt caches, evicted least
    # recently retained first when a new sequence needs a lane
    retained: dict = dataclasses.field(default_factory=dict)
    # lane -> int32 NumPy [max_seq] slot -> position map (after seq_div);
    # absent = positions are the slots
    slot_pos: dict = dataclasses.field(default_factory=dict)
    # lane -> M-RoPE text-position delta: after a Qwen2-VL image chunk, text
    # positions resume at base + max(gh, gw), so positions = slot + delta
    mrope_delta: dict = dataclasses.field(default_factory=dict)

    @property
    def quantized(self) -> bool:
        return isinstance(self.k[0], tuple)

    @property
    def n_lanes(self) -> int:
        return (self.k[0][0] if self.quantized else self.k[0]).shape[0]

    @classmethod
    def create(cls, cfg: ModelConfig, n_lanes: int, max_seq: int,
               dtype=torch.bfloat16, device="cpu", quant: str = "none",
               max_chunk: int = 512, tp: int = 1) -> "KVCache":
        """``max_chunk``: the largest step the context runs; a ring must hold
        window + T - 1 slots for every attended slot to survive a T-row step.
        ``tp``: one tensor-parallel shard's cache, of n_kv_heads / tp heads
        (an MLA model's one latent head whole); q4 then packs head pairs when
        the local head count is even, as JAX's (Hkv / 2) % tp test does."""
        hkv = cfg.kv_cache_heads if cfg.is_mla else cfg.kv_cache_heads // tp
        sizes = [min(max_seq, -(-(cfg.swa_window + max_chunk) // 128) * 128)
                 if cfg.is_swa(li) else max_seq for li in range(cfg.n_layers)]

        def make(s, d):
            shape = (n_lanes, hkv, s, d)
            if quant == "none":
                return torch.zeros(shape, dtype=dtype, device=device)
            scales = torch.ones((n_lanes, hkv, 1, s), dtype=torch.float32, device=device)
            if quant == "q8":
                codes = torch.zeros(shape, dtype=torch.int8, device=device)
            elif quant == "q4" and hkv % 2 == 0:
                codes = torch.zeros((n_lanes, hkv // 2, s, d), dtype=torch.uint8, device=device)
            elif quant == "q4":
                codes = torch.zeros((n_lanes, hkv, s, d // 2), dtype=torch.uint8, device=device)
            else:
                raise ValueError(f"KV cache quantization {quant!r}: not none, q8 or q4")
            return codes, scales

        k = [make(s, cfg.kv_k_dim) for s in sizes]
        v = [make(s, cfg.kv_v_dim) for s in sizes]
        return cls(k=k, v=v, max_seq=max_seq, lengths=[0] * n_lanes,
                   seq_ids=[None] * n_lanes, sizes=sizes)

    def tensors(self) -> list:
        """Every device tensor of the cache (codes and scales alike)."""
        out = []
        for c in self.k + self.v:
            out.extend(c if isinstance(c, tuple) else (c,))
        return out

    def nbytes(self) -> int:
        """Resident bytes of the cache on its device."""
        return sum(t.numel() * t.element_size() for t in self.tensors())

    def find_free_lane(self) -> Optional[int]:
        for i, s in enumerate(self.seq_ids):
            if s is None:
                return i
        return None

    def lane_of(self, seq_id: int) -> int:
        return self.seq_ids.index(seq_id)

    def seq_new(self, seq_id: int) -> int:
        lane = self.find_free_lane()
        if lane is None and self.retained:
            # evict the least recently retained prompt cache
            self.seq_rm(min(self.retained, key=self.retained.get))
            lane = self.find_free_lane()
        if lane is None:
            raise RuntimeError("KV cache: no free lane")
        self.seq_ids[lane] = seq_id
        self.lengths[lane] = 0
        self.slot_pos.pop(lane, None)
        self.mrope_delta.pop(lane, None)
        return lane

    def mark_retained(self, seq_id: int) -> None:
        if seq_id in self.seq_ids:
            self.retained[seq_id] = time.monotonic()

    def unmark_retained(self, seq_id: int) -> None:
        self.retained.pop(seq_id, None)

    def has_seq(self, seq_id: int) -> bool:
        return seq_id in self.seq_ids

    def seq_rm(self, seq_id: int, p0: int = 0) -> None:
        """Remove positions >= p0 of a sequence (p0 = 0 frees the lane)."""
        lane = self.lane_of(seq_id)
        if p0 == 0:
            self.seq_ids[lane] = None
            self.lengths[lane] = 0
            self.retained.pop(seq_id, None)
            self.slot_pos.pop(lane, None)
            self.mrope_delta.pop(lane, None)
        else:
            self.lengths[lane] = min(self.lengths[lane], p0)

    def _lane_caches(self, lane: int) -> list:
        """(k, v, index) of every layer cache holding ``lane``, the lane's
        index in that cache."""
        return [(k, v, lane) for k, v in zip(self.k, self.v)]

    def _copy_lane(self, src: int, dst: int) -> None:
        for c in self.tensors():
            c[dst].copy_(c[src])

    def seq_cp(self, src_seq: int, dst_seq: int) -> None:
        """Fork a sequence into a fresh lane (whole-lane copy, in place)."""
        src = self.lane_of(src_seq)
        dst = self.seq_new(dst_seq)
        self._copy_lane(src, dst)
        self.lengths[dst] = self.lengths[src]
        if src in self.slot_pos:
            self.slot_pos[dst] = self.slot_pos[src].copy()
        if src in self.mrope_delta:
            self.mrope_delta[dst] = self.mrope_delta[src]

    def seq_keep(self, seq_id: int) -> None:
        for s in list(self.seq_ids):
            if s is not None and s != seq_id:
                self.seq_rm(s)

    def lengths_array(self) -> torch.Tensor:
        return torch.tensor(self.lengths, dtype=torch.int32)

    def seq_shift(self, cfg: ModelConfig, seq_id: int, n_keep: int, n_discard: int) -> None:
        """Context shift: drop cells [n_keep, n_keep + n_discard), slide the
        tail down, and re-rotate the moved K by -n_discard positions (RoPE is
        additive in position, so one delta rotation corrects them). As in the
        JAX package, the whole lane is rolled and rotated in f32 and the first
        n_keep cells are kept as they were; a quantized K lane is dequantized,
        shifted and requantized whole (the kept cells included), while V codes
        and scales are only rolled. An MLA row rotates only its leading
        ``qk_rope_dim`` dims, with MLA's rope (interleaved pairs, YaRN's mscale
        cancelled). The lane's tensors are updated in place."""
        import dataclasses

        from rrs_tpu_torch.models.llama import mla_rope_params, rope_params
        from rrs_tpu_torch.ops.basic import apply_rope
        from rrs_tpu_torch.runtime import kv_codec

        if cfg.any_swa:
            # as the JAX package (and the reference's iSWA cache): no context
            # shift over ring caches
            raise RuntimeError("context shift is not supported for SWA models")
        lane = self.lane_of(seq_id)
        n = self.lengths[lane]
        n_discard = min(n_discard, n - n_keep)
        if n_discard <= 0:
            return
        if cfg.is_mla:
            rp = dataclasses.replace(mla_rope_params(cfg), head_dim=cfg.kv_k_dim,
                                     rot_dim=cfg.qk_rope_dim)
        else:
            rp = rope_params(cfg)

        def roll(x):                                    # [H, S, ...] lane tensor, slots dim 1
            keep = torch.arange(self.max_seq, device=x.device) < n_keep
            return torch.where(keep.reshape((1, -1) + (1,) * (x.dim() - 2)), x,
                               torch.roll(x, -n_discard, dims=1))

        def shift_k(lk):                                # [H, S, D] -> f32 rolled + rotated
            delta = torch.full((1, 1), -n_discard, dtype=torch.int32, device=lk.device)
            keep = torch.arange(self.max_seq, device=lk.device)[None, :, None] < n_keep
            tail = torch.roll(lk, -n_discard, dims=1)
            rk = apply_rope(tail.transpose(0, 1)[None], delta, rp)[0].transpose(0, 1)
            return torch.where(keep, lk, rk)

        for k, v, ll in self._lane_caches(lane):
            if isinstance(k, tuple):
                (arr, sc), (varr, vsc) = k, v
                lk = kv_codec.dequantize(arr[ll], sc[ll])           # [H, S, D] f32
                q, s_new = kv_codec.quantize_rows(shift_k(lk), kv_codec.kv_qmax(arr))
                arr[ll] = kv_codec.pack_like(q, arr[ll], sc[ll])
                sc[ll, :, 0] = s_new
                varr[ll] = roll(varr[ll])
                vsc[ll, :, 0] = roll(vsc[ll, :, 0])
                continue
            k[ll] = shift_k(k[ll]).to(k.dtype)
            v[ll] = roll(v[ll])
        self.lengths[lane] = n - n_discard

    def positions_row(self, lane: int, start: int, t: int):
        """RoPE positions (int32 NumPy [t]) for t new tokens written at slots
        [start, start + t): the slots, plus the lane's M-RoPE delta, unless
        ``seq_div`` remapped the lane."""
        import numpy as np

        sp = self.slot_pos.get(lane)
        if sp is None:
            return np.arange(start, start + t, dtype=np.int32) + self.mrope_delta.get(lane, 0)
        return sp[start:start + t].copy()

    def pos_offset(self, lane: int) -> int:
        """position - slot for the lane's next token (constant for all later
        slots)."""
        sp = self.slot_pos.get(lane)
        if sp is None:
            return self.mrope_delta.get(lane, 0)
        n = self.lengths[lane]
        return int(sp[min(n, self.max_seq - 1)]) - n

    def mrope_begin_image(self, lane: int, gh: int, gw: int):
        """Qwen2-VL M-RoPE positions for an image chunk of gh x gw merged grid
        tokens about to be appended to this lane: channel t stays at the
        chunk's base position while h / w walk the grid's rows / columns; the
        text after it resumes at base + max(gh, gw), recorded as the lane's
        delta. Returns the chunk's int32 [gh * gw, 3] (t, h, w) rows."""
        import numpy as np

        base = self.lengths[lane] + self.mrope_delta.get(lane, 0)
        r = np.arange(gh * gw, dtype=np.int32)
        rows = np.stack([np.full(gh * gw, base, np.int32), base + r // gw, base + r % gw], axis=1)
        self.mrope_delta[lane] = base + max(gh, gw) - (self.lengths[lane] + gh * gw)
        return rows

    def seq_div(self, cfg: ModelConfig, seq_id: int, p0: int, p1: int, d: int) -> None:
        """Self-extend: divide the positions of this sequence's cached cells
        whose position lies in [p0, p1) by d. Cells stay in their slots (floor
        division is monotone, so the slot-ordered causal mask stays valid) and
        the cached K is re-rotated by each slot's position delta; later tokens
        continue at max(new positions) + 1 through ``slot_pos``. As in the
        JAX package, a quantized K lane is dequantized, rotated and
        requantized whole. The rotation's cos / sin table is computed on the
        host, so that the card and the CPU rotate by the same bits. Raises for
        a model with sliding layers."""
        import numpy as np

        from rrs_tpu_torch.models.llama import mla_rope_params, rope_params
        from rrs_tpu_torch.ops.basic import rope_angles, rotate_cos_sin
        from rrs_tpu_torch.runtime import kv_codec

        if d <= 1:
            return
        if cfg.any_swa:
            raise RuntimeError("seq_div is not supported for SWA models")
        lane = self.lane_of(seq_id)
        n = self.lengths[lane]
        if n == 0:
            return
        pos = self.slot_pos.get(lane)
        pos = np.arange(self.max_seq, dtype=np.int32) if pos is None else pos.copy()
        p0 = max(p0, 0)
        if p1 < 0:
            p1 = np.iinfo(np.int32).max
        sel = (pos[:n] >= p0) & (pos[:n] < p1)
        if not sel.any():
            return
        new_prefix = pos[:n].copy()
        new_prefix[sel] //= d
        delta_np = np.zeros((self.max_seq,), np.int32)
        delta_np[:n] = new_prefix - pos[:n]
        pos[:n] = new_prefix
        pos[n:] = int(new_prefix.max()) + 1 + np.arange(self.max_seq - n, dtype=np.int32)
        self.slot_pos[lane] = pos
        if not delta_np.any():
            return
        if cfg.is_mla:
            rp = dataclasses.replace(mla_rope_params(cfg), head_dim=cfg.kv_k_dim,
                                     rot_dim=cfg.qk_rope_dim)
        else:
            rp = rope_params(cfg)
        angles, mscale = rope_angles(torch.from_numpy(delta_np)[None, :], rp)      # [1, S, rot/2]
        cos = torch.cos(angles) * mscale
        sin = torch.sin(angles) * mscale

        def rotate(lk):                                  # [H, S, D] -> f32 rotated
            return rotate_cos_sin(lk.to(torch.float32).transpose(0, 1)[None],
                                  cos.to(lk.device), sin.to(lk.device),
                                  rp.rot_dim or rp.head_dim, rp.neox)[0].transpose(0, 1)

        for k, _, ll in self._lane_caches(lane):
            if isinstance(k, tuple):
                arr, sc = k
                q, s_new = kv_codec.quantize_rows(
                    rotate(kv_codec.dequantize(arr[ll], sc[ll])), kv_codec.kv_qmax(arr))
                arr[ll] = kv_codec.pack_like(q, arr[ll], sc[ll])
                sc[ll, :, 0] = s_new
                continue
            k[ll] = rotate(k[ll]).to(k.dtype)


@dataclasses.dataclass
class ShardedKVCache(KVCache):
    """The lane state of a cache over a (dp, tp) mesh, and ``parts[d][r]``,
    the ``KVCache`` of shard (d, r): the lanes of dp row d, tp rank r's kv
    heads, on the shard's device (None for another process's shard). ``k``
    and ``v`` stay empty: the forward takes each shard's part."""

    parts: list = dataclasses.field(default_factory=list)
    dp: int = 1

    @classmethod
    def create_sharded(cls, cfg: ModelConfig, n_lanes: int, max_seq: int, mesh,
                       dtype=torch.bfloat16, quant: str = "none",
                       max_chunk: int = 512) -> "ShardedKVCache":
        if n_lanes % mesh.dp:
            raise ValueError(f"n_lanes={n_lanes} must be divisible by dp={mesh.dp}")
        parts = [[None] * mesh.tp for _ in range(mesh.dp)]
        sizes = []
        for d, r in mesh.local():
            part = KVCache.create(cfg, n_lanes // mesh.dp, max_seq, dtype,
                                  device=mesh.device(d, r), quant=quant, max_chunk=max_chunk,
                                  tp=mesh.tp)
            parts[d][r] = part
            sizes = part.sizes
        return cls(k=[], v=[], max_seq=max_seq, lengths=[0] * n_lanes,
                   seq_ids=[None] * n_lanes, sizes=sizes, parts=parts, dp=mesh.dp)

    def _local_parts(self):
        return [p for row in self.parts for p in row if p is not None]

    @property
    def quantized(self) -> bool:
        return self._local_parts()[0].quantized

    @property
    def n_lanes(self) -> int:
        return len(self.lengths)

    def tensors(self) -> list:
        return [t for p in self._local_parts() for t in p.tensors()]

    def _where(self, lane: int):
        """(dp row, index in the row's parts) of a lane."""
        return divmod(lane, self.n_lanes // self.dp)

    def _lane_caches(self, lane: int) -> list:
        d, ll = self._where(lane)
        return [(k, v, ll) for p in self.parts[d] if p is not None
                for k, v in zip(p.k, p.v)]

    def _copy_lane(self, src: int, dst: int) -> None:
        (ds, ls), (dd, ld) = self._where(src), self._where(dst)
        for ps, pd in zip(self.parts[ds], self.parts[dd]):
            if ps is None and pd is None:
                continue
            if ps is None or pd is None:
                raise NotImplementedError(
                    "seq_cp between dp rows held by different processes")
            for a, b in zip(ps.tensors(), pd.tensors()):
                b[ld].copy_(a[ls])
