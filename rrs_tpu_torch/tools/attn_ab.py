"""Same-card before / after of the attention kernels B3 (``flash_attention``,
bf16 KV) and B6 (``flash_attention_q8``), with B7 (``flash_attention_q4hp``)
as a control, against an older tree of this repository; and a sweep of the
prefill body's tile and ring stages for bf16 and q8 rows.

    python3 -m rrs_tpu_torch.tools.attn_ab --parent DIR [--json OUT] [--served] [--sweep]

DIR holds an older checkout (for example ``git archive <commit>``
unpacked) from before B3 and B6 moved onto ``csrc/attention_sm90.cuh``. Its
``rrs_tpu_torch/csrc/flash_attention.cu`` (B3, entry
``rrs_flash_attention``), ``flash_attention_kvq.cu`` (B6, entry
``rrs_flash_attention_kvq``) and ``flash_attention_q4.cu`` (B7 / B8, entry
``rrs_flash_attention_q4``) are built in a temporary directory with this
tree's ``nvcc`` flags. At the shapes ``chip_smoke.py`` times (phase 2:
qwen3-4b widths, H = 32, Hkv = 8, D = 128, generate's T = 1 over 384 and
1,024 slots and T = 64 over 1,024, a served decode step over 4 lanes of
4,096 slots at 3999 / 1500 / 299 with lane 3 dead, a 4 x 1,024 prefill chunk
from 0 / 2048 / 3000; phase 10: gpt-oss-20b's 640-slot ring, window 128,
sinks) both kernels run on the same inputs, in turns (old, new, new, old,
CUDA events, caches rotated past L2), beside SDPA on bf16 caches
(dequantized beforehand for the quantized ones), in two forms (K/V expanded
to the query heads with ``repeat_interleave``, and unexpanded with
``enable_gqa=True``; the faster is the yardstick), and the shape's bound.
The new kernel is held to its plain version and to the old one (within
8e-3), its padded rows to exactly 0, and two of its launches on the same
inputs to the same bits. B7 is the same code in both trees, so its ratio
reads the noise. With ``--served`` it also profiles served decode steps of
qwen3-4b (fabricated weights, 36 layers) over a bf16 and a q8 cache of 4
lanes x 4,096 slots, three lanes at 3,000 / 1,500 / 300 tokens, the model's
B3 (B6) calls going to the old kernel and to the new one in turns (old,
new, new, old): device ms a step in attention and in all, by
``torch.profiler``. With ``--sweep`` it builds this tree's attention
sources again with each prefill tile and stage count of SWEEP and times the
prefill body over bf16, q8 and q4hp rows on the prefill chunk and
generate's T = 64, the variants in turns. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from rrs_tpu_torch import kernels
from rrs_tpu_torch.models import llama
from rrs_tpu_torch.ops import attn_split, splitk
from rrs_tpu_torch.ops import flash_attention as fa
from rrs_tpu_torch.runtime import kv_codec
from rrs_tpu_torch.tools.gemm_ab import BF16_FLOPS, BYTES_S, build_old, n_copies, rel, time_ms

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the older tree's entries
OLD_SIGNATURES = {
    "rrs_flash_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P],
    "rrs_flash_attention_kvq": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _F, _F, _I, _P],
    "rrs_flash_attention_q4": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _F, _F, _I, _I, _I, _P, _P, _P]}
OLD_SOURCES = ("flash_attention.cu", "flash_attention_kvq.cu", "flash_attention_q4.cu")
# kernel -> cache codec; B7 is the control
KERNELS = {"flash_attention": "bf16", "flash_attention_q8": "q8", "flash_attention_q4hp": "q4hp"}
TOL = 8e-3                  # bf16 output (chip_smoke.py's attention tolerance)
# (label, H, Hkv, D, S, T, each lane's first position (-1: dead), window, sinks)
SHAPES = [("generate T=1 S=384", 32, 8, 128, 384, 1, (367,), 0, False),
          ("generate T=1 S=1024", 32, 8, 128, 1024, 1, (1000,), 0, False),
          ("generate T=64 S=1024", 32, 8, 128, 1024, 64, (900,), 0, False),
          ("served decode T=1 B=4 S=4096", 32, 8, 128, 4096, 1, (3999, 1500, 299, -1), 0, False),
          ("prefill chunk T=1024 B=4 S=4096", 32, 8, 128, 4096, 1024, (0, 2048, 3000, -1), 0,
           False),
          ("gpt-oss ring T=1 B=2 S=640 window 128 sinks", 64, 8, 64, 640, 1, (1000, 700), 128,
           True)]
# the prefill body's (tile slots, ring stages) tried (64 x 3 does not fit at D = 256)
SWEEP = ((32, 2), (32, 3), (64, 2))


def caches(codec, b, hkv, s, d, gen):
    """Random K and V on the card in the codec's layout: (k, v) bf16 rows,
    or (k codes, k scales, v codes, v scales)."""
    if codec == "bf16":
        return tuple(torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
                     for _ in range(2))
    out = []
    for _ in range(2):
        x = torch.randn((b, hkv, s, d), generator=gen, device="cuda")
        codes, sc = kv_codec.quantize_rows(x, 127.0 if codec == "q8" else 7.0)
        codes = {"q8": codes, "q4hp": kv_codec.pack_hp(codes), "q4": kv_codec.pack4(codes)}[codec]
        out += [codes.contiguous(), sc[:, :, None, :].contiguous()]
    return tuple(out)


def row_bytes(codec, d):
    """Bytes of one kv head's slot: its row and, quantized, its f32 scale."""
    return {"bf16": 2 * d, "q8": d + 4}.get(codec, d // 2 + 4)


def bf16_caches(c):
    """(k, v) in bf16: the rows themselves, or the codes dequantized."""
    if len(c) == 2:
        return c
    return (kv_codec.dequantize(c[0], c[1]).to(torch.bfloat16),
            kv_codec.dequantize(c[2], c[3]).to(torch.bfloat16))


def plain(q, c, pos, scale, **kw):
    return (fa.attention_ref if len(c) == 2 else fa.attention_kvq_ref)(q, *c, pos, scale, **kw)


def mask_of(pos, s, window):
    """The SDPA boolean mask [B, 1, T, S] of the kernels' rule."""
    kv = torch.arange(s, device=pos.device)
    p = pos[:, :, None].to(torch.int64)
    if window > 0:
        real = p - torch.remainder(p - kv, s)
        m = (real >= 0) & (real > p - window)
    else:
        m = (kv <= p) & (p >= 0)
    return m[:, None]


def sdpa_forms(q, sets, mask, g, scale, reps):
    """SDPA on bf16 caches, expanded and with enable_gqa: {form: ms}."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q.transpose(1, 2)
    kv = [bf16_caches(c) for c in sets]
    exp = [(k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)) for k, v in kv]
    return {"expanded": time_ms(lambda k, v: sdpa(qt, k, v, attn_mask=mask, scale=scale), exp,
                                reps),
            "enable_gqa": time_ms(lambda k, v: sdpa(qt, k, v, attn_mask=mask, scale=scale,
                                                   enable_gqa=True), kv, reps)}


def old_kernel(old_lib, codec):
    """The older tree's kernel for ``codec`` behind the wrappers' signature
    (no ALiBi or softcap: the model paths timed here use neither)."""
    def call(q, *c_pos_scale, softcap=0.0, window=0, sinks=None, alibi=0.0):
        if softcap or alibi:
            raise ValueError("attn_ab: the older kernels are bound without softcap or ALiBi")
        *c, pos, scale = c_pos_scale
        b, t, h, d = q.shape
        out = torch.empty_like(q)
        sk = None if sinks is None else torch.as_tensor(
            sinks, dtype=torch.float32, device=q.device).reshape(h).contiguous()
        pos = pos.to(dtype=torch.int32).contiguous()
        stream = kernels.stream_ptr(q.device)
        common = (pos.data_ptr(), splitk.ptr(sk), None, out.data_ptr())
        if codec == "bf16":
            k, v = c
            hkv, s = k.shape[1], k.shape[2]
            code = old_lib.rrs_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), *common, b, t, h, hkv, s, d,
                float(scale), 0.0, int(window), stream)
        else:
            kq, ks, vq, vs = c
            hkv, s = ks.shape[1], ks.shape[3]
            args = (q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
                    *common, b, t, h, hkv, s, d, float(scale), 0.0, int(window))
            if codec == "q8":
                code = old_lib.rrs_flash_attention_kvq(0, *args, stream)
            else:
                # the older entry takes the same plan, from shapes only
                p = attn_split.plan(codec, b, hkv, t, h // hkv, s, d)
                scratch, counters = attn_split.buffers(p, q.device)
                code = old_lib.rrs_flash_attention_q4(
                    1 if codec == "q4hp" else 2, *args, p.n_split, p.split_tiles,
                    splitk.ptr(scratch), splitk.ptr(counters), stream)
        if code != 0:
            raise RuntimeError(f"older kernel: launch returned {code}")
        return out
    return call


def variant_kernel(lib, name):
    """This tree's wrapper ``name`` with its kernel library swapped for the
    variant build ``lib`` during the call."""
    fn = getattr(fa, name)

    def call(*args):
        saved, kernels._lib = kernels._lib, lib
        try:
            return fn(*args)
        finally:
            kernels._lib = saved
    return call


def build_variants() -> dict:
    """This tree's kernel sources built once per (tile, stages) of SWEEP:
    {(tile, stages): library}."""
    tmp = Path(tempfile.mkdtemp(prefix="attn_sweep_"))
    for p in kernels.CSRC.iterdir():
        if p.suffix in (".cu", ".cuh"):
            shutil.copy(p, tmp / p.name)
    nvcc = kernels._nvcc()
    names = ("flash_attention.cu", "flash_attention_q8.cu", "flash_attention_q4.cu")
    jobs = {}
    for tile, stages in SWEEP:
        for name in names:
            obj = tmp / f"{tile}_{stages}_{name}.o"
            jobs[obj] = subprocess.Popen(
                [nvcc, *kernels.NVCC_FLAGS, f"-DRRS_ATTN_PREFILL_TILE={tile}",
                 f"-DRRS_ATTN_PREFILL_STAGES={stages}", "-c", str(tmp / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj, p in jobs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"variant {obj.name} failed to build:\n{log}")
    libs = {}
    for tile, stages in SWEEP:
        path = tmp / f"libattn_{tile}_{stages}.so"
        subprocess.run([nvcc, kernels.ARCH, "-shared",
                        *[str(tmp / f"{tile}_{stages}_{n}.o") for n in names], "-o", str(path)],
                       check=True)
        lib = ctypes.CDLL(str(path))
        lib.rrs_flash_attention.argtypes = kernels.SIGNATURES["rrs_flash_attention"]
        lib.rrs_flash_attention.restype = ctypes.c_int
        libs[(tile, stages)] = lib
    return libs


def _inputs(label, h, hkv, d, s, t, starts, window, with_sinks, gen):
    b = len(starts)
    q = torch.randn((b, t, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    pos = torch.tensor([[st + i if st >= 0 else -1 for i in range(t)] for st in starts],
                       device="cuda", dtype=torch.int32)
    if t > 1:
        pos[0, -1] = -1                                         # one padded row
    sinks = torch.randn((h,), generator=gen, device="cuda") if with_sinks else None
    return q, pos, sinks


def sweep(libs) -> list[dict]:
    """The prefill body of each variant on the prefill chunk and generate's
    T = 64 over bf16, q8 and q4hp rows, the variants in turns (forward, then
    back), each held to the plain version."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    rows = []
    for shape in SHAPES:
        label, h, hkv, d, s, t, starts, window, with_sinks = shape
        if t * (h // hkv) <= attn_split.DECODE_ROWS:
            continue
        q, pos, _ = _inputs(*shape, gen)
        scale = 1.0 / math.sqrt(d)
        reps = 10 if t <= 64 else 3
        for name, codec in KERNELS.items():
            sets = [caches(codec, len(starts), hkv, s, d, gen)
                    for _ in range(n_copies(2 * len(starts) * hkv * s * row_bytes(codec, d)))]
            fns = {v: variant_kernel(lib, name) for v, lib in libs.items()}
            ref = plain(q, sets[0], pos, scale)
            for v, fn in fns.items():
                r = rel(fn(q, *sets[0], pos, scale), ref)
                if r > TOL:
                    raise AssertionError(f"sweep {name} {v} {label}: rel {r:.2e} to plain")
            ms = {v: [] for v in fns}
            for v in list(fns) + list(fns)[::-1]:
                ms[v].append(time_ms(lambda *c, fn=fns[v]: fn(q, *c, pos, scale), sets, reps))
            for v, pair in ms.items():
                rows.append({"kernel": name, "shape": label, "tile": v[0], "stages": v[1],
                             "ms": sum(pair) / 2, "turns_ms": pair})
            print(f"  sweep {name} {label}: " + ", ".join(
                f"tile {v[0]} x {v[1]} stages {sum(p) / 2:.4f} ms" for v, p in ms.items()),
                flush=True)
            del sets
            torch.cuda.empty_cache()
    return rows


def served(old_lib, steps: int = 8) -> list[dict]:
    """Served decode steps of qwen3-4b over 4 x 4,096 bf16 and q8 caches,
    B3 / B6 old and new in turns, profiled."""
    from torch.profiler import ProfilerActivity, profile

    from rrs_tpu_torch.models.config import PRESETS
    from rrs_tpu_torch.runtime.context import InferenceContext

    cfg = PRESETS["qwen3-4b"]
    weights = llama.fabricated_tcq4_weights(cfg, seed=0, device="cuda")
    rows = []
    for quant, name, codec in (("none", "flash_attention", "bf16"),
                               ("q8", "flash_attention_q8", "q8")):
        ctx = InferenceContext(cfg, weights, n_lanes=4, max_seq=4096, kv_quant=quant)
        rng = torch.Generator().manual_seed(3)
        seqs, first, lengths = [], {}, {}
        for n in (3000, 1500, 300):
            seq = ctx.new_sequence()
            logits = ctx.prefill(seq, torch.randint(2, cfg.vocab_size, (n,),
                                                    generator=rng).tolist(), all_logits=False)
            seqs.append(seq)
            first[seq] = int(logits[-1].argmax())
            lengths[seq] = ctx.kv.lengths[ctx.kv.lane_of(seq)]
        kernels_of = {"old": old_kernel(old_lib, codec), "new": getattr(fa, name)}
        original = getattr(llama, name)

        def run():
            for seq in seqs:
                ctx.kv.seq_rm(seq, p0=lengths[seq])
            feed = dict(first)
            for _ in range(steps):
                out = ctx.decode(feed)
                feed = {seq: int(out[seq].argmax()) for seq in seqs}
            torch.cuda.synchronize()

        try:
            for turn in ("old", "new", "new", "old"):
                setattr(llama, name, kernels_of[turn])
                run()                                               # warm
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    run()
                events = [e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA]
                attn = sum(e.time_range.elapsed_us() for e in events
                           if any(k in e.name for k in ("attention_kernel", "flash_kernel",
                                                        "kvq_kernel")))
                total = sum(e.time_range.elapsed_us() for e in events)
                rows.append({"cache": codec, "kernel": turn,
                             "attention_ms_step": attn / 1e3 / steps,
                             "device_ms_step": total / 1e3 / steps})
                print(f"  served decode step, {codec} KV, {name} {turn}: attention "
                      f"{attn / 1e3 / steps:.3f} of {total / 1e3 / steps:.3f} device ms a step "
                      f"({steps} steps, lanes at {sorted(lengths.values(), reverse=True)} + the "
                      f"new tokens, 36 layers)", flush=True)
        finally:
            setattr(llama, name, original)
        del ctx
        torch.cuda.empty_cache()
    return rows


def run(old_lib) -> list[dict]:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    rows: list[dict] = []
    for shape in SHAPES:
        label, h, hkv, d, s, t, starts, window, with_sinks = shape
        b, g = len(starts), h // hkv
        scale = 1.0 / math.sqrt(d)
        q, pos, sinks = _inputs(*shape, gen)
        kw = dict(window=window, sinks=sinks)
        reps = 40 if t == 1 else (10 if t <= 64 else 3)
        valid = pos[pos >= 0].to(torch.int64)
        if window > 0:
            slots, pairs = b * min(s, window), b * t * h * min(s, window)
        else:
            slots = sum(int(r.max()) + 1 for r in pos if int(r.max()) >= 0)
            pairs = int((valid + 1).sum()) * h
        for name, codec in KERNELS.items():
            code_bytes = row_bytes(codec, d)
            sets = [caches(codec, b, hkv, s, d, gen)
                    for _ in range(n_copies(2 * b * hkv * s * code_bytes))]
            new_fn = getattr(fa, name)

            def old(*c, fn=old_kernel(old_lib, codec)):
                return fn(q, *c, pos, scale, **kw)

            def new(*c, fn=new_fn):
                return fn(q, *c, pos, scale, **kw)

            got, again, prev = new(*sets[0]), new(*sets[0]), old(*sets[0])
            ref = plain(q, sets[0], pos, scale, **kw)
            torch.cuda.synchronize()
            r_plain, r_old = rel(got, ref), rel(got, prev)
            zero = not bool((pos < 0).any()) or float(got[pos < 0].float().abs().max()) == 0.0
            if not (torch.isfinite(got.float()).all() and r_plain <= TOL and r_old <= TOL
                    and zero and torch.equal(got, again)):
                raise AssertionError(f"{name} {label}: rel {r_plain:.2e} to plain, {r_old:.2e} "
                                     f"to the older kernel, padded rows 0: {zero}, two launches "
                                     f"bit-equal: {torch.equal(got, again)}")
            turns = [time_ms(f, sets, reps) for f in (old, new, new, old)]
            lib = sdpa_forms(q, sets[:2], mask_of(pos, s, window), g, scale, reps)
            form = min(lib, key=lib.get)
            t_bytes = (2 * hkv * slots * code_bytes + 2 * b * t * h * d * 2 + b * t * 4) \
                / BYTES_S * 1e3
            t_ops = 4 * d * pairs / BF16_FLOPS * 1e3
            row = {"kernel": name, "shape": f"{label} H={h} Hkv={hkv} D={d}",
                   "old_ms": (turns[0] + turns[3]) / 2, "new_ms": (turns[1] + turns[2]) / 2,
                   "library_ms": lib[form], "library_form": form,
                   "library_expanded_ms": lib["expanded"], "library_gqa_ms": lib["enable_gqa"],
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "rel_plain": r_plain, "rel_old": r_old, "turns_ms": turns}
            rows.append(row)
            print(f"  {name} {label}: old {row['old_ms']:.4f} new {row['new_ms']:.4f} ms "
                  f"({row['old_ms'] / row['new_ms']:.2f}x) SDPA {lib[form]:.4f} ({form}; "
                  f"expanded {lib['expanded']:.4f}, enable_gqa {lib['enable_gqa']:.4f}) bound "
                  f"{row['bound_ms']:.4f} ({row['bound_by']}); turns "
                  f"{' / '.join(f'{x:.4f}' for x in turns)}; rel {r_plain:.1e} to plain, "
                  f"{r_old:.1e} to old; bit-equal twice", flush=True)
            del sets
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path, help="an older tree of this repo")
    ap.add_argument("--json", type=Path, help="write the rows here")
    ap.add_argument("--served", action="store_true",
                    help="also profile served bf16 and q8 decode steps of qwen3-4b, old and new")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the prefill body's tile and stage variants of SWEEP")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attn_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}; {smi}", flush=True)
    kernels.lib()
    old_lib = build_old(args.parent, OLD_SOURCES, OLD_SIGNATURES)
    sweep_rows = sweep(build_variants()) if args.sweep else []
    rows = run(old_lib)
    steps = served(old_lib) if args.served else []
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"device": smi, "rows": rows, "served": steps,
                                         "sweep": sweep_rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
