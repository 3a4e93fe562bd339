#!/usr/bin/env python3
"""On-card smoke run of rrs_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the stated peaks) and the repository around
it; exits non-zero without either, and on any failed phase. Phases:

1. build: compile every kernel in rrs_tpu_torch/csrc with nvcc (parallel,
   one process per source) and print the seconds it took;
2. kernel parity: each kernel of the generate path against its plain PyTorch
   version at the qwen3-4b shapes of that path, with the stated tolerance,
   timed with CUDA events beside its bound, its plain version and one PyTorch
   library call for the same product; then each kernel's other
   instantiations and options, untimed;
3. main path: a 2-layer model on the card against the same weights on the
   CPU, then ``generate`` at full qwen3-4b width (36 layers, fabricated TCQ4
   weights, Q8_0 lm_head) for three greedy requests and one sampled one, with
   every kernel's launch count read after the run, and a torch.profiler
   breakdown of a few decode steps;
4. the ``{"kernels": [...]}`` line, the card's name and power limit, and the
   last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

GB = 1e9
# Published dense peaks (NVIDIA data sheets): bytes/s, bf16 FLOP/s, int8 OP/s.
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 1513e12),
    "H100 NVL": (3.9e12, 835e12, 1671e12),
    "H200": (4.8e12, 989e12, 1979e12),
    "H100": (3.35e12, 989e12, 1979e12),     # SXM
}

QWEN3_4B_LINEARS = {            # (K, N) of the fused projections of one layer
    "qkv": (2560, 6144), "o": (4096, 2560), "gate_up": (2560, 19456), "down": (9728, 2560),
}
L2_BYTES = 50e6


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    return PEAKS["H100"]


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def time_ms(fn, arg_sets, reps: int = 20) -> float:
    """Mean device time of fn over reps launches, rotating through arg_sets
    (copies of the weights, together larger than L2, so every launch reads
    its weights from device memory as the model's layers do). A short device
    sleep first lets the host queue the launches, so host launch overhead
    does not show as device gaps."""
    import torch

    for i in range(3):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(reps * 2e5))
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def n_copies(nbytes: float) -> int:
    return max(2, min(24, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


class Report:
    def __init__(self, name, source, replaces, bound_by):
        self.entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                      "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "bound_ms": 0.0, "bound_by": bound_by, "library_ms": 0.0,
                      "shapes": []}

    def add(self, shape: dict, headline: bool):
        self.entry["shapes"].append(shape)
        self.entry["max_abs_err"] = max(self.entry["max_abs_err"], shape["max_abs_err"])
        if headline:
            for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                self.entry[key] += shape[key]
        print(f"  {self.entry['name']} {shape['shape']}: err {shape['max_abs_err']:.3e} "
              f"(rel {shape['rel_err']:.2e} <= {shape['tol']:.0e}) ms {shape['ms']:.4f} "
              f"bound {shape['bound_ms']:.4f} ({shape['bound_by']}) plain {shape['plain_ms']:.4f} "
              f"library {shape['library_ms']:.4f}", flush=True)


def compare(name, got, ref, tol):
    import torch

    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    rel = err / max(scale, 1e-30)
    if not (torch.isfinite(got.float()).all() and rel <= tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain version: "
                             f"max abs err {err:.3e}, rel {rel:.3e} > {tol:.0e}")
    return err, rel


def phase_parity(peaks):
    """Each kernel against its plain version at the qwen3-4b main-path shapes."""
    import torch

    from rrs_tpu_torch.ops import flash_attention as fa
    from rrs_tpu_torch.ops import q8_matmul as q8
    from rrs_tpu_torch.ops import tcq4_matmul as tm

    bw, bf16_peak, int8_peak = peaks
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ms = lambda b: b / bw * 1e3                             # noqa: E731

    def tcq4_weights(k, n, copies):
        return [(torch.randint(0, 256, (k // 2, n), generator=gen, device=dev,
                               dtype=torch.uint8),
                 (torch.rand((k // 32, n), generator=gen, device=dev) * 0.01 + 0.001
                  ).to(torch.bfloat16)) for _ in range(copies)]

    reports = {}

    # -- gx2: decode M = 1, all four projections --------------------------
    rep = reports["gx2"] = Report("tcq4_matmul_gx2", "rrs_tpu_torch/csrc/tcq4_gx2.cu",
                                  "rrs_tpu/ops/tcq4_matmul.py:1262", "bytes")
    for lname, (k, n) in QWEN3_4B_LINEARS.items():
        wbytes = k // 2 * n + k // 32 * n * 2
        ws = tcq4_weights(k, n, n_copies(wbytes))
        a = torch.randn((1, k), generator=gen, device=dev)
        got = tm.tcq4_matmul_gx2(a, *ws[0])
        ref = tm.tcq4_matmul_gx2_plain(a, *ws[0])
        err, rel = compare(f"gx2 {lname}", got, ref, 1e-5)
        wl = [(w[0], tm.dequantize_w(*w).to(torch.bfloat16)) for w in ws[:max(2, n_copies(2 * k * n))]]
        a16 = a.to(torch.bfloat16)
        nbytes = wbytes + k * 4 + n * 4
        rep.add({"shape": f"{lname} M=1 K={k} N={n}", "max_abs_err": err, "rel_err": rel,
                 "tol": 1e-5,
                 "ms": time_ms(tm.tcq4_matmul_gx2, [(a, q, e) for q, e in ws], 40),
                 "plain_ms": time_ms(tm.tcq4_matmul_gx2_plain, [(a, q, e) for q, e in ws], 10),
                 "library_ms": time_ms(torch.matmul, [(a16, w) for _, w in wl], 40),
                 "bound_ms": max(ms(nbytes), 2 * k * n / int8_peak * 1e3),
                 "bound_by": "bytes" if ms(nbytes) >= 2 * k * n / int8_peak * 1e3 else "operations"},
                headline=True)
        del ws, wl

    # -- tcq4_matmul: prefill buckets M = 16, 64, 512 ----------------------
    rep = reports["tcq4"] = Report("tcq4_matmul", "rrs_tpu_torch/csrc/tcq4_matmul.cu",
                                   "rrs_tpu/ops/tcq4_matmul.py:895", "operations")
    for m in (16, 64, 512):
        for lname, (k, n) in QWEN3_4B_LINEARS.items():
            wbytes = k // 2 * n + k // 32 * n * 2
            ws = tcq4_weights(k, n, n_copies(wbytes))
            a = (torch.randint(-7, 8, (m, k), generator=gen, device=dev).float()
                 * (torch.rand((m, 1), generator=gen, device=dev) + 0.5) / 7.0)
            got = tm.tcq4_matmul(a, *ws[0])
            ref = tm.tcq4_matmul_plain(a, *ws[0])
            err, rel = compare(f"tcq4_matmul {lname} M={m}", got, ref, 1e-3)
            wl = [tm.dequantize_w(*w).to(torch.bfloat16) for w in ws[:2]]
            a16 = a.to(torch.bfloat16)
            t_bytes = ms(wbytes + m * k * 4 + m * n * 4)
            t_ops = 2 * m * k * n / bf16_peak * 1e3
            rep.add({"shape": f"{lname} M={m} K={k} N={n}", "max_abs_err": err, "rel_err": rel,
                     "tol": 1e-3,
                     "ms": time_ms(tm.tcq4_matmul, [(a, q, e) for q, e in ws], 20),
                     "plain_ms": time_ms(tm.tcq4_matmul_plain, [(a, q, e) for q, e in ws[:2]], 5),
                     "library_ms": time_ms(torch.matmul, [(a16, w) for w in wl], 20),
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations"},
                    headline=(m == 512))
            del ws, wl

    # -- q8_matmul: the padded lm_head at M = 1 and 64 ----------------------
    rep = reports["q8"] = Report("q8_matmul", "rrs_tpu_torch/csrc/q8_matmul.cu",
                                 "rrs_tpu/ops/q8_matmul.py:48", "bytes")
    k, n = 2560, 153600
    qw = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
    qs_ = torch.rand((k // 32, n), generator=gen, device=dev) * 1e-3
    wl = (qw.float().reshape(k // 32, 32, n) * qs_[:, None]).reshape(k, n).to(torch.bfloat16)
    for m in (1, 64):
        a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        got = q8.q8_matmul(a, qw, qs_)
        ref = q8.q8_matmul_plain(a, qw, qs_)
        err, rel = compare(f"q8_matmul M={m}", got, ref, 1e-3)
        t_bytes = ms(k * n + k // 32 * n * 4 + m * k * 2 + m * n * 4)
        t_ops = 2 * m * k * n / bf16_peak * 1e3
        rep.add({"shape": f"lm_head M={m} K={k} N={n}", "max_abs_err": err, "rel_err": rel,
                 "tol": 1e-3,
                 "ms": time_ms(q8.q8_matmul, [(a, qw, qs_)], 20),
                 "plain_ms": time_ms(q8.q8_matmul_plain, [(a, qw, qs_)], 3),
                 "library_ms": time_ms(torch.matmul, [(a, wl)], 20),
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations"},
                headline=(m == 1))
    del qw, qs_, wl

    # -- flash_attention: T = 1 and 64 over S = 384, one padded row ---------
    rep = reports["fa"] = Report("flash_attention", "rrs_tpu_torch/csrc/flash_attention.cu",
                                 "rrs_tpu/ops/flash_attention.py:343", "bytes")
    h, hkv, d, s = 32, 8, 128, 384
    for t in (1, 64):
        kv_bytes = 2 * hkv * s * d * 2
        caches = [(torch.randn((1, hkv, s, d), generator=gen, device=dev).to(torch.bfloat16),
                   torch.randn((1, hkv, s, d), generator=gen, device=dev).to(torch.bfloat16))
                  for _ in range(n_copies(kv_bytes))]
        q = torch.randn((1, t, h, d), generator=gen, device=dev).to(torch.bfloat16)
        start = s - t - 16                                  # rows attend most of the cache
        pos = torch.arange(start, start + t, device=dev, dtype=torch.int32)[None]
        if t > 1:
            pos[0, -1] = -1                                 # one padded row
        scale = 1.0 / math.sqrt(d)
        got = fa.flash_attention(q, *caches[0], pos, scale)
        ref = fa.attention_ref(q, *caches[0], pos, scale)
        err, rel = compare(f"flash_attention T={t}", got, ref, 8e-3)
        if t > 1 and got[0, -1].float().abs().max().item() != 0.0:
            raise AssertionError("flash_attention: a padded row must output 0")
        valid = pos[0][pos[0] >= 0].to(torch.int64)
        pairs = int((valid + 1).sum().item()) * h          # unmasked (row, slot) pairs
        slots = int(pos.max().item()) + 1
        t_bytes = ms(2 * hkv * slots * d * 2 + 2 * t * h * d * 2 + t * 4)
        t_ops = 4 * d * pairs / bf16_peak * 1e3
        g = h // hkv
        mask = (torch.arange(s, device=dev)[None, :] <= pos[0][:, None]) & (pos[0][:, None] >= 0)
        lib_sets = [(q.transpose(1, 2), kc.repeat_interleave(g, 1), vc.repeat_interleave(g, 1),
                     mask[None, None]) for kc, vc in caches[:4]]
        sdpa = lambda qq, kk, vv, mm: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qq, kk, vv, attn_mask=mm, scale=scale)
        rep.add({"shape": f"T={t} H={h} Hkv={hkv} D={d} S={s}", "max_abs_err": err,
                 "rel_err": rel, "tol": 8e-3,
                 "ms": time_ms(lambda kc, vc: fa.flash_attention(q, kc, vc, pos, scale), caches, 40),
                 "plain_ms": time_ms(lambda kc, vc: fa.attention_ref(q, kc, vc, pos, scale),
                                     caches, 10),
                 "library_ms": time_ms(sdpa, lib_sets, 40),
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations"},
                headline=(t == 1))
        del caches, lib_sets
    torch.cuda.empty_cache()
    return reports


SMALL_TOL = {"tcq4_matmul_gx2": 1e-5, "tcq4_matmul": 1e-3, "q8_matmul": 1e-3,
             "flash_attention": 8e-3}


def phase_variants():
    """Each kernel's other instantiations against its plain version: gx2 at
    M = 2 and 8 and a ragged N, the prefill kernel with a bf16 output (padded
    M >= 1024) and a ragged N, and attention at head dims 64 and 256, without
    grouping, over two lanes with one padded, and with each option (window
    over a ring cache, softcap, ALiBi, sinks)."""
    import torch

    from rrs_tpu_torch.ops import flash_attention as fa
    from rrs_tpu_torch.ops import tcq4_matmul as tm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    done = []

    def weights(k, n):
        return (torch.randint(0, 256, (k // 2, n), generator=gen, device=dev, dtype=torch.uint8),
                (torch.rand((k // 32, n), generator=gen, device=dev) * 0.01 + 0.001
                 ).to(torch.bfloat16))

    for m, k, n in ((2, 2560, 6144), (8, 2560, 2560), (1, 512, 200)):
        qs, eff = weights(k, n)
        a = torch.randn((m, k), generator=gen, device=dev)
        compare(f"gx2 M={m} K={k} N={n}", tm.tcq4_matmul_gx2(a, qs, eff),
                tm.tcq4_matmul_gx2_plain(a, qs, eff), SMALL_TOL["tcq4_matmul_gx2"])
        done.append(f"gx2 M={m} N={n}")
    for m, k, n in ((1024, 2560, 2560), (40, 512, 200)):
        qs, eff = weights(k, n)
        a = torch.randn((m, k), generator=gen, device=dev)
        got = tm.tcq4_matmul(a, qs, eff)
        out_bf16 = m >= 1024
        if got.dtype != (torch.bfloat16 if out_bf16 else torch.float32):
            raise AssertionError(f"tcq4_matmul M={m}: output dtype {got.dtype}")
        # a bf16 output may land one ulp (2^-8 relative) off where the two
        # sums round to either side of a bf16 step
        compare(f"tcq4_matmul M={m} N={n}", got, tm.tcq4_matmul_plain(a, qs, eff),
                8e-3 if out_bf16 else SMALL_TOL["tcq4_matmul"])
        done.append(f"tcq4_matmul M={m} N={n} {str(got.dtype)[6:]}")
    cases = {"D=64": dict(d=64), "D=256": dict(d=256), "G=1": dict(h=8, hkv=8),
             "B=2 dead lane": dict(b=2), "window ring": dict(s=64, window=24, start=100),
             "softcap": dict(softcap=20.0), "alibi": dict(alibi=8.0), "sinks": dict(sinks=True)}
    for name, c in cases.items():
        b, t, h, hkv, d, s = c.get("b", 1), 9, c.get("h", 8), c.get("hkv", 2), c.get("d", 128), \
            c.get("s", 160)
        start = c.get("start", 60)
        q = torch.randn((b, t, h, d), generator=gen, device=dev).to(torch.bfloat16)
        kc = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(torch.bfloat16)
        vc = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(torch.bfloat16)
        pos = torch.arange(start, start + t, device=dev, dtype=torch.int32).repeat(b, 1)
        pos[0, -2:] = -1                                    # two padded rows
        if b > 1:
            pos[1] = -1                                     # a lane with no token
        kw = dict(softcap=c.get("softcap", 0.0), window=c.get("window", 0),
                  alibi=c.get("alibi", 0.0))
        if c.get("sinks"):
            kw["sinks"] = torch.randn((h,), generator=gen, device=dev)
        scale = 1.0 / math.sqrt(d)
        got = fa.flash_attention(q, kc, vc, pos, scale, **kw)
        compare(f"flash_attention {name}", got, fa.attention_ref(q, kc, vc, pos, scale, **kw),
                SMALL_TOL["flash_attention"])
        if got[pos < 0].float().abs().max().item() != 0.0:
            raise AssertionError(f"flash_attention {name}: a padded row must output 0")
        done.append(f"flash {name}")
    print(f"  variants agree with their plain versions: {', '.join(done)}", flush=True)


# Card-vs-CPU limit on the dense 2-layer model's logits (relative L2). bf16
# rounding alone stays far below it; on the CPU, storing K/V one slot late
# moves these logits by >= 0.22, dropping RoPE by >= 0.66 and halving the FFN
# output by >= 0.47.
GLUE_TOL = 0.05


def phase_small_reference():
    """A 2-layer model (E=1024, 16/8 heads x 128) through prefill and one
    decode step, on the card and on the CPU.

    With W4A4 weights every kernel launch is checked against its plain
    version on the very inputs it got (teacher forcing). Their end-to-end
    logits are only reported: the int4 activation quantizer turns last-bit
    differences into code flips, and on the CPU alone scaling rms_norm's
    input by (1 + 2^-20) moves them by a relative L2 of 0.18-0.29 and can
    change the argmax. The glue is held where no int4 step amplifies
    rounding: the same config with dense bf16 weights must give the CPU's
    logits within GLUE_TOL, and the W4A4 glue (rotation with a gather,
    activation quant) must give the CPU's values op by op."""
    import torch

    from rrs_tpu_torch.formats.tcq4 import quantize_activations_rrs
    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.config import ModelConfig
    from rrs_tpu_torch.models.linear import rotate_activations
    from rrs_tpu_torch.ops import flash_attention as fa
    from rrs_tpu_torch.ops import q8_matmul as q8
    from rrs_tpu_torch.ops import tcq4_matmul as tm
    from rrs_tpu_torch.runtime.context import InferenceContext

    gen = torch.Generator().manual_seed(2)
    x = torch.randn((64, 2560), generator=gen).to(torch.bfloat16)
    gather = torch.cat([torch.randperm(256, generator=gen) for _ in range(10)])
    rot = rotate_activations(x.cuda(), gather.cuda())
    rot_ref = rotate_activations(x, gather)
    rel = ((rot.cpu() - rot_ref).abs().max() / rot_ref.abs().max()).item()
    if rel > 1e-6:
        raise AssertionError(f"rotation on the card vs the CPU: rel {rel:.3e} > 1e-6")
    (a_q, a_s), (r_q, r_s) = quantize_activations_rrs(rot), quantize_activations_rrs(rot.cpu())
    if not (torch.equal(a_q.cpu(), r_q) and torch.equal(a_s.cpu(), r_s)):
        raise AssertionError("activation quant on the card differs from the CPU's")
    print(f"  W4A4 glue, card vs CPU: rotation rel {rel:.2e} <= 1e-6, "
          "activation quant bit-exact", flush=True)

    cfg = ModelConfig(arch="qwen3", n_layers=2, n_embd=1024, n_heads=16, n_kv_heads=8,
                      head_dim=128, n_ff=3072, vocab_size=4096, context_length=4096,
                      rope_theta=1e6, qk_norm=True)
    models = {"W4A4": llama.fabricated_tcq4_weights(cfg, seed=1, device="cpu"),
              "dense": llama.random_weights(cfg, seed=1, device="cpu")}
    prompt = list(range(7, 47))                              # 40 tokens -> bucket 64
    worst: dict = {}
    hooked = [(tm, "tcq4_matmul_gx2", tm.tcq4_matmul_gx2_plain),
              (tm, "tcq4_matmul", tm.tcq4_matmul_plain),
              (q8, "q8_matmul", q8.q8_matmul_plain),
              (llama, "flash_attention", fa.attention_ref)]
    originals = [getattr(mod, name) for mod, name, _ in hooked]

    def checked(name, kernel, plain):
        def run(*args, **kwargs):
            out = kernel(*args, **kwargs)
            ref = plain(*args, **kwargs)
            err = (out.float() - ref.float()).abs().max().item()
            rel = err / max(ref.float().abs().max().item(), 1e-30)
            if not torch.isfinite(out.float()).all() or rel > SMALL_TOL[name]:
                raise AssertionError(f"small model: {name} {tuple(args[0].shape)} disagrees "
                                     f"with its plain version (rel {rel:.3e})")
            worst[name] = max(worst.get(name, 0.0), rel)
            return out
        return run

    logits = {}
    try:
        for (mod, name, plain), orig in zip(hooked, originals):
            setattr(mod, name, checked(name, orig, plain))
        for kind, w_cpu in models.items():
            for dev, w in (("cuda", llama.to_device(w_cpu, "cuda")), ("cpu", w_cpu)):
                ctx = InferenceContext(cfg, w, max_seq=256, device=dev)
                seq = ctx.new_sequence()
                pre = ctx.prefill(seq, prompt)[-1]
                dec = ctx.decode({seq: 11})[seq]
                logits[kind, dev] = (pre.float().cpu(), dec.float().cpu())
    finally:
        for (mod, name, _), orig in zip(hooked, originals):
            setattr(mod, name, orig)
    if set(worst) != set(SMALL_TOL):
        raise AssertionError(f"small model: kernels not reached: {set(SMALL_TOL) - set(worst)}")
    print("  small model, each launch vs its plain version on the same inputs (max rel): "
          + ", ".join(f"{k} {v:.2e} <= {SMALL_TOL[k]:.0e}" for k, v in worst.items()), flush=True)
    for kind in models:
        for i, stage in enumerate(("prefill", "decode")):
            got, ref = logits[kind, "cuda"][i], logits[kind, "cpu"][i]
            if got.shape != ref.shape or not torch.isfinite(got).all():
                raise AssertionError(f"small {kind} model {stage}: bad logits {tuple(got.shape)}")
            rel = ((got - ref).norm() / ref.norm()).item()
            held = kind == "dense"
            print(f"  small {kind} model {stage} end to end, card vs CPU: rel L2 {rel:.4f}"
                  + (f" <= {GLUE_TOL}" if held else " (reported)")
                  + f", argmax {int(got.argmax())} vs {int(ref.argmax())}", flush=True)
            if held and rel > GLUE_TOL:
                raise AssertionError(f"small dense model {stage}: the card's logits differ "
                                     f"from the CPU's by rel L2 {rel:.4f} > {GLUE_TOL}")


def phase_main_path(reports):
    import torch

    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.config import PRESETS
    from rrs_tpu_torch.runtime.context import InferenceContext
    from rrs_tpu_torch.runtime.sampler import SamplerParams

    cfg = PRESETS["qwen3-4b"]
    t0 = time.perf_counter()
    weights = llama.fabricated_tcq4_weights(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  fabricated qwen3-4b weights in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = torch.Generator().manual_seed(0)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist() for n in (5, 40, 300)]

    warm = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024)
    warm.generate(prompts[0], 2)                              # first-call set-up
    del warm
    ctx = InferenceContext(cfg, weights, n_lanes=1, max_seq=1024)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = {"gx2": "tcq4_matmul_gx2", "tcq4": "tcq4_matmul", "q8": "q8_matmul",
                "fa": "flash_attention"}
    kernels.reset_launches()
    outs = [ctx.generate(p, 32) for p in prompts]
    outs.append(ctx.generate(prompts[1], 32, SamplerParams(temperature=0.8, top_k=40, seed=0)))
    torch.cuda.synchronize()
    launches = {key: kernels.LAUNCHES[name] for key, name in counters.items()}
    for out in outs:
        if len(out) != 32 or not all(0 <= tok < cfg.vocab_size for tok in out):
            raise AssertionError(f"generate returned {len(out)} tokens: {out}")
    perf = ctx.perf()
    peak = torch.cuda.max_memory_allocated() / GB
    print(f"  requests: prompts 5/40/300 (+40 sampled) x 32 new tokens; "
          f"prefill {perf['n_p_eval']} tok @ {perf['pp_tok_per_s']:.1f} tok/s, "
          f"decode {perf['n_eval']} tok @ {perf['tg_tok_per_s']:.2f} tok/s "
          f"({perf['t_eval_ms'] / max(perf['n_eval'], 1):.3f} ms/token), "
          f"peak memory {peak:.2f} GB", flush=True)
    print(f"  greedy tokens (first request): {outs[0][:8]}...", flush=True)
    print(f"  launches on the main path: {launches}", flush=True)
    for key, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {key} was never launched on the main path")
        reports[key].entry["launches"] = n
    profile_decode(ctx, prompts[1])
    return perf


KERNEL_NAMES = {"gx2_kernel": "tcq4_matmul_gx2", "tcq4_gemm_kernel": "tcq4_matmul",
                "q8_gemm_kernel": "q8_matmul", "flash_kernel": "flash_attention"}


def profile_decode(ctx, prompt, steps: int = 8):
    """Where a decode step's time goes at qwen3-4b width: the wall time of
    a few eager decode steps, then torch.profiler over as many more. Prints
    the wall time per step, the device time per step (sum of kernel
    durations; one stream, so they do not overlap), the device's idle share,
    the kernels launched per step, and the device time of the port's four
    kernels and of the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    seq = ctx.new_sequence()
    try:
        ctx.prefill(seq, prompt)
        for tok in (11, 12):                                  # warm-up steps
            ctx.decode({seq: tok})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            ctx.decode({seq: 13 + i})
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(steps):
                ctx.decode({seq: 13 + steps + i})
            torch.cuda.synchronize()
    finally:
        ctx.kv.seq_rm(seq)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("  decode profile: the profiler recorded no device time (not measured)",
              flush=True)
        return
    by_name: dict = {}
    for e in kernels:
        short = next((v for k, v in KERNEL_NAMES.items() if k in e.name), "other")
        by_name[short] = by_name.get(short, 0.0) + e.time_range.elapsed_us() / 1e3
    dev_ms = sum(by_name.values()) / steps
    split = ", ".join(f"{k} {v / steps:.3f}" for k, v in sorted(by_name.items(),
                                                               key=lambda kv: -kv[1]))
    print(f"  decode profile ({steps} steps, qwen3-4b, S={ctx.kv.max_seq}): wall "
          f"{wall_ms:.3f} ms/step, device {dev_ms:.3f} ms/step, idle share "
          f"{1 - dev_ms / wall_ms:.3f}, {len(kernels) / steps:.0f} kernels/step; "
          f"device ms/step by kernel: {split}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.device import set_matmul_precision

    set_matmul_precision()
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    print(f"[device] {name}, {torch.cuda.device_count()} visible; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; peaks {peaks[0] / 1e12:.2f} TB/s, "
          f"{peaks[1] / 1e12:.0f} TFLOP/s bf16, {peaks[2] / 1e12:.0f} TOP/s int8", flush=True)

    print("[1/4] build", flush=True)
    t0 = time.perf_counter()
    path = kernels.build()
    kernels.lib()
    print(f"  built {path.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    print("[2/4] kernel parity at the qwen3-4b main-path shapes", flush=True)
    reports = phase_parity(peaks)
    phase_variants()

    print("[3/4] main path: small-model reference, then generate at qwen3-4b width",
          flush=True)
    phase_small_reference()
    phase_main_path(reports)

    print("[4/4] summary", flush=True)
    print(json.dumps({"kernels": [r.entry for r in reports.values()]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
