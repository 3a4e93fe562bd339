"""Same-card before / after of the weight matmuls against an older tree of
this repository: B2 (``q8_matmul``) and B4 (``tcq4_matmul``), B11
(``mxfp4_matmul``) and B5 (``tcq4_matmul_i8p``), B13
(``mxfp4_matmul_all_experts``) and B10 (``tcq4_matmul_all_experts``), B12
(``mxfp4_matmul_experts_rows``) and B9 (``tcq4_matmul_experts_rows``), B1
(``tcq4_matmul_gx2``) and B15 (``tcq4_matmul_gx3``), or B18
(``tcq4_matmul_pb``) and B16 (``tcq4_matmul_a8``).

    python3 -m rrs_tpu_torch.tools.gemm_ab --parent DIR [--subjects b11,b5] [--json OUT]

DIR holds an older checkout (for example ``git archive <commit>`` unpacked).
The subjects' sources in its ``rrs_tpu_torch/csrc`` are copied to a
temporary directory, built there with this tree's ``nvcc`` flags into a
library of their own, and bound with the older C signatures: for ``b2,b4``
those before the split-K plan (a parent older than the sm90 GEMM bodies),
for ``b11,b5`` those before B11 and B5 took it (the default; a parent older
than their sm90 redesign), for ``b13,b10`` those before the expert grid (a
parent older than B10's and B13's move onto it), for ``b12,b9`` those
before the selected rows ran on the split-K stream (a parent older than
that move; its B9 entry needs its ``tcq4_matmul.cu`` too), for ``b1,b15``
those before the split-K integer stream, for ``b18,b16`` those before B18
moved onto ``gemm_sm90.cuh`` and B16 onto B1's body (a parent older than
that move, such as 4051f56). ``b2,b4,b11`` checks a parent whose B2, B4
and B11 entries take this tree's arguments (one as old as the expert grid's
parent): the SASS of every ``splitk_kernel``, ``gemm_kernel``,
``experts_kernel`` and ``rows_kernel`` in their sources is compared with
the parent's where the parent has it (``cuobjdump``), with the registers
and spills ``ptxas`` reports for each kernel of the two bodies in this
tree; then this tree's wrappers run on the parent's library, and every
output must be the parent's bit for bit, at B2's, B4's and B11's shapes
below. ``b1,b14,b15`` does the same for ``tcq4_gx2.cu``'s
``gx_sm90_kernel`` instantiations of B1, B14 and B15 (a parent whose gx
entries take this tree's arguments, such as 4051f56) at B1's shapes. At
each shape both kernels run on the same
inputs, in turns (old, new, new, old, CUDA events, weight copies rotated past
L2), beside ``torch.matmul`` on bf16 weights dequantized beforehand (and, for
B5, ``torch._int_mm`` on its int8 codes and decoded w8 weights), timed over
as many copies as the kernels get, and the shape's bound. The new kernel is
held to its plain version and to the old one. Shapes: B4 at the four
qwen3-4b projections at M = 4, 16, 64, 512 and the down projection at M = 2
and 8, B2 at the qwen3-4b lm_head at M = 1, 4, 64 and at gpt-oss-20b's qkv
and o at M = 1, 4, 2048 and its lm_head at M = 1; B11 at one gpt-oss-20b
expert projection (K 2,880, N 2,944) at M = 4, 300 and 2,048 (a decode step,
the overflow scan of a 300-token prompt, a served 4 x 512 prefill chunk); B5
at the four qwen3-4b projections at M = 256, 512 and 4,096 (bf16 out), with
the four summed; B10 at Qwen3-30B-A3B's gate / up (K 2,048, N 768) and down
(K 768, N 2,048) over per-expert C = 64 and shared T = 64, B13 at
gpt-oss-20b's (E = 32, K 2,880, N 2,944) over shared T = 64 and per-expert
C = 128, beside ``torch.bmm`` / ``torch.matmul`` on the stacks dequantized
to bf16 beforehand; B9 at Qwen3-30B-A3B's gate / up and down at n_sel = 8,
32 and 128 (1, 4 and 16 decode tokens, top-8 of E = 128), B12 at
gpt-oss-20b's expert projection at n_sel = 4, 16 and 64 (top-4 of E = 32),
each over id sets that take every expert in turn (``rotating_ids``), held
to its plain version and bit for bit to itself across two launches (its
order of sums differs from the parent's), beside ``torch.bmm`` on the
selected experts gathered and dequantized to bf16 beforehand, over as many
gathered copies as pass 2 x L2; B1 / B15 (and B14) at ``gx_shapes``, B18
/ B16 as ``run_b18_b16`` says. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from rrs_tpu_torch import kernels
from rrs_tpu_torch.ops import mxfp4_matmul as mx
from rrs_tpu_torch.ops import q8_matmul as q8
from rrs_tpu_torch.ops import splitk
from rrs_tpu_torch.ops import tcq4_matmul as tm

L2_BYTES = 50e6
BYTES_S, BF16_FLOPS, INT8_OPS = 3.35e12, 989e12, 1979e12        # H100 SXM data sheet
_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_SIGNATURES = {"rrs_q8_matmul": [_P, _I, _P, _P, _P, _I, _I, _I, _P],
                  "rrs_tcq4_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _P]}
OLD_SIGNATURES_B11_B5 = {"rrs_mxfp4_matmul": [_P, _I, _P, _P, _P, _I, _I, _I, _P],
                         "rrs_tcq4_i8p": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]}
OLD_SIGNATURES_B13_B10 = {"rrs_mxfp4_all_experts": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P],
                          "rrs_tcq4_all_experts": [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P]}
OLD_SIGNATURES_B12_B9 = {"rrs_mxfp4_rows": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
                         "rrs_tcq4_experts_rows": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P]}
OLD_SIGNATURES_B1_B15 = {"rrs_tcq4_gx2": [_P, _P, _P, _P, _I, _I, _I, _P],
                         "rrs_tcq4_gx3": [_P, _I, _P, _P, _P, _I, _I, _I, _P]}
OLD_SIGNATURES_B18_B16 = {"rrs_tcq4_pb": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
                          "rrs_tcq4_a8": [_P, _P, _P, _P, _P, _I, _I, _I, _P]}
SAME_ABI = ("rrs_q8_matmul", "rrs_tcq4_matmul", "rrs_mxfp4_matmul")
SAME_ABI_GX = ("rrs_tcq4_gx2", "rrs_tcq4_gx", "rrs_tcq4_gx3")
SUBJECTS = {"b2,b4": (("q8_matmul.cu", "tcq4_matmul.cu"), OLD_SIGNATURES),
            "b11,b5": (("mxfp4_matmul.cu", "tcq4_i8p.cu"), OLD_SIGNATURES_B11_B5),
            "b13,b10": (("mxfp4_matmul.cu", "tcq4_experts.cu"), OLD_SIGNATURES_B13_B10),
            "b12,b9": (("mxfp4_matmul.cu", "tcq4_experts.cu", "tcq4_matmul.cu"),
                       OLD_SIGNATURES_B12_B9),
            "b2,b4,b11": (("q8_matmul.cu", "tcq4_matmul.cu", "mxfp4_matmul.cu"),
                          {name: kernels.SIGNATURES[name] for name in SAME_ABI}),
            "b1,b15": (("tcq4_gx2.cu",), OLD_SIGNATURES_B1_B15),
            "b1,b14,b15": (("tcq4_gx2.cu",),
                           {name: kernels.SIGNATURES[name] for name in SAME_ABI_GX}),
            "b18,b16": (("tcq4_pb.cu", "tcq4_a8.cu"), OLD_SIGNATURES_B18_B16)}
SASS_SUBJECTS = {"b2,b4,b11", "b1,b14,b15"}
# the kernels whose SASS is compared, and those whose ptxas report is printed
SASS_KERNELS = "gemm_kernel|splitk_kernel|experts_kernel|rows_kernel|gx_sm90_kernel"
QWEN3_4B = {"qkv": (2560, 6144), "o": (4096, 2560), "gate_up": (2560, 19456),
            "down": (9728, 2560)}
QWEN3_30B_ATTN = {"30b qkv": (2048, 5120), "30b o": (4096, 2048)}
GPTOSS_Q8 = {"qkv": (3072, 5120), "o": (4096, 2944), "lm_head": (3072, 202752)}


def build_old(parent: Path, sources=("q8_matmul.cu", "tcq4_matmul.cu"),
              signatures=OLD_SIGNATURES) -> ctypes.CDLL:
    """The older tree's kernels in ``sources`` (files of its
    ``rrs_tpu_torch/csrc``), built in a temporary directory with this tree's
    ``nvcc`` flags and bound with the older C ``signatures``."""
    tmp = Path(tempfile.mkdtemp(prefix="ab_old_"))
    src = parent / "rrs_tpu_torch" / "csrc"
    for p in src.iterdir():
        if p.suffix in (".cu", ".cuh"):
            shutil.copy(p, tmp / p.name)
    nvcc = kernels._nvcc()
    procs = [subprocess.Popen([nvcc, *kernels.NVCC_FLAGS, "-c", str(tmp / name), "-o",
                               str(tmp / (name + ".o"))], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for name in sources]
    for p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError("older kernels failed to build:\n" + log)
    lib_path = tmp / "libab_old.so"
    subprocess.run([nvcc, kernels.ARCH, "-shared", *[str(tmp / (name + ".o")) for name in sources],
                    "-o", str(lib_path)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in signatures.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def sass(src: Path, tmp: Path) -> tuple[dict, dict]:
    """{kernel: SASS instructions} of the kernels in ``src`` and {kernel:
    ptxas's registers and spills} of those of gemm_sm90.cuh's two bodies and
    of tcq4_gx2.cu's, built with this tree's flags."""
    nvcc = kernels._nvcc()
    cubin = tmp / (src.stem + ".cubin")
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    r = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-cubin", str(src), "-o", str(cubin)],
                       capture_output=True, text=True, check=True)
    lines, regs = (r.stdout + r.stderr).splitlines(), {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m and re.search(SASS_KERNELS, m.group(1)):
            regs[m.group(1)] = " ".join(x.split(":", 1)[-1].strip() for x in lines[i + 2:i + 4])
    dump = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), []) if "_kernel" in m.group(1) else None
        elif cur is not None and (m := re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(.*?);", line)):
            cur.append(m.group(1).strip())
    return funcs, regs


def canon(name: str) -> str:
    """A mangled kernel name without its file's anonymous namespace, and a
    ``gx_sm90_kernel`` of one n8 tile of rows under the name it had before
    the tile count became a template argument."""
    name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "(anon)", name)
    return re.sub(r"(gx_sm90_kernelILi\dE(?:f|13__nv_bfloat16))Li1E", r"\1", name)


def compare_sass(parent: Path, sources) -> list[dict]:
    """Every kernel of ``sources`` that SASS_KERNELS names, here and in the
    parent: the same SASS or not (``canon`` names), or new where the parent
    has no such kernel; and ptxas's report of this tree's kernels."""
    tmp = Path(tempfile.mkdtemp(prefix="ab_sass_"))
    rows = []
    for name in sources:
        (tmp / "new").mkdir(exist_ok=True)
        (tmp / "old").mkdir(exist_ok=True)
        new, regs = sass(kernels.CSRC / name, tmp / "new")
        old = {canon(k): v for k, v in sass(parent / "rrs_tpu_torch" / "csrc" / name,
                                            tmp / "old")[0].items()}
        for kernel, report in regs.items():
            row = {"source": name, "kernel": canon(kernel), "ptxas": report}
            if canon(kernel) in old:
                row["sass_identical"] = old[canon(kernel)] == new[kernel]
            rows.append(row)
            same = {True: "SASS identical to the parent's", False: "SASS differs from the "
                    "parent's"}.get(row.get("sass_identical"), "new")
            print(f"  {name} {canon(kernel)}: {same}; {report}", flush=True)
    return rows


def n_copies(nbytes: float) -> int:
    return max(2, min(24, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def rotating_ids(n_exp: int, lanes: int, top_k: int, n_sets: int, gen) -> list:
    """``n_sets`` int32 id sets on ``gen``'s device of ``lanes`` x ``top_k``
    expert ids, each lane's ``top_k`` distinct: consecutive chunks of a
    stream of permutations of the experts, so that an expert comes round
    again only after the stream has passed every other one (a whole stack
    read between two reads of it, past L2 where the stack is)."""
    if n_exp % top_k:
        raise ValueError(f"rotating_ids: {n_exp} experts in chunks of {top_k}")
    per = lanes * top_k
    stream = torch.cat([torch.randperm(n_exp, generator=gen, device=gen.device)
                        for _ in range(-(-n_sets * per // n_exp))])
    return [stream[j * per:(j + 1) * per].to(torch.int32) for j in range(n_sets)]


def time_ms(fn, arg_sets, reps: int) -> float:
    for i in range(3):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(reps * 2e5))
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _checked(code: int) -> None:
    if code != 0:
        raise RuntimeError(f"older kernel: launch returned {code}")


def rel(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


def on_lib(old_lib, wrapper):
    """``wrapper`` (this tree's) launching the older tree's kernel: for a
    parent whose C entry takes this tree's arguments."""
    def run(*args):
        saved, kernels._lib = kernels._lib, old_lib
        try:
            return wrapper(*args)
        finally:
            kernels._lib = saved
    return run


def ab(label, old, new, plain, lib, sets, lib_sets, nbytes, flops, reps, tol, rows,
       peak=BF16_FLOPS, extra=None, same_bits=False, self_bits=False):
    """Hold new to plain and to old (bit for bit with ``same_bits``; to
    itself across two launches with ``self_bits``), then time old, new, new,
    old and the library call (and ``extra``: name -> (call, arg sets), each
    timed as ``<name>_ms``); append and print the row."""
    got, ref, prev = new(*sets[0]), plain(*sets[0]), old(*sets[0])
    torch.cuda.synchronize()
    r_plain, r_old = rel(got, ref), rel(got, prev)
    if not (torch.isfinite(got.float()).all() and r_plain <= tol and r_old <= tol):
        raise AssertionError(f"{label}: new kernel off: rel {r_plain:.2e} to plain, "
                             f"{r_old:.2e} to the older kernel")
    if same_bits and not torch.equal(got, prev):
        raise AssertionError(f"{label}: not the older kernel's output bit for bit")
    if self_bits and not torch.equal(got, new(*sets[0])):
        raise AssertionError(f"{label}: two launches of the new kernel differ")
    t = [time_ms(f, sets, reps) for f in (old, new, new, old)]
    t_bytes, t_ops = nbytes / BYTES_S * 1e3, flops / peak * 1e3
    row = {"shape": label, "old_ms": (t[0] + t[3]) / 2, "new_ms": (t[1] + t[2]) / 2,
           "library_ms": time_ms(lib, lib_sets, reps), "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "rel_plain": r_plain, "rel_old": r_old, "turns_ms": t,
           **({"bit_equal_to_old": True} if same_bits else {}),
           **({"two_launches_bit_equal": True} if self_bits else {})}
    for name, (call, call_sets) in (extra or {}).items():
        row[f"{name}_ms"] = time_ms(call, call_sets, reps)
    rows.append(row)
    more = "".join(f" {name} {row[name + '_ms']:.4f}" for name in (extra or {}))
    print(f"  {label}: old {row['old_ms']:.4f} new {row['new_ms']:.4f} ms "
          f"({row['old_ms'] / row['new_ms']:.2f}x) library {row['library_ms']:.4f}{more} "
          f"bound {row['bound_ms']:.4f} ({row['bound_by']}); turns "
          f"{' / '.join(f'{x:.4f}' for x in t)}; rel {r_plain:.1e} to plain, "
          f"{r_old:.1e} to old", flush=True)


def old_calls(old_lib, subjects: str) -> dict:
    """The older tree's kernels as functions of this tree's wrappers'
    arguments: through the older C signatures, or (``b2,b4,b11``) through
    this tree's wrappers on the older library."""
    if subjects == "b2,b4,b11":
        return {"tcq4": on_lib(old_lib, tm.tcq4_matmul), "q8": on_lib(old_lib, q8.q8_matmul),
                "mx": on_lib(old_lib, mx.mxfp4_matmul)}
    if subjects == "b1,b14,b15":
        return {"gx2": on_lib(old_lib, tm.tcq4_matmul_gx2),
                "gx": on_lib(old_lib, tm.tcq4_matmul_gx),
                "gx3": on_lib(old_lib, tm.tcq4_matmul_gx3)}
    dev = torch.device("cuda")
    stream = lambda: kernels.stream_ptr(dev)                    # noqa: E731

    def old_tcq4(a, qs, eff):
        m, k = a.shape
        n = qs.shape[1]
        out_bf16 = tm.tcq4_out_bf16(m)
        out = torch.empty((m, n), dtype=torch.bfloat16 if out_bf16 else torch.float32,
                          device=dev)
        _checked(old_lib.rrs_tcq4_matmul(a.data_ptr(), qs.data_ptr(), eff.data_ptr(),
                                         out.data_ptr(), m, k, n, int(out_bf16), stream()))
        return out

    def old_q8(a, q, scale):
        m, k = a.shape
        out = torch.empty((m, q.shape[1]), dtype=torch.float32, device=dev)
        _checked(old_lib.rrs_q8_matmul(a.data_ptr(), int(a.dtype == torch.bfloat16),
                                       q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, k,
                                       q.shape[1], stream()))
        return out

    def old_mx(a, qs, sx):
        m, k = a.shape
        out = torch.empty((m, qs.shape[1]), dtype=torch.float32, device=dev)
        _checked(old_lib.rrs_mxfp4_matmul(a.data_ptr(), int(a.dtype == torch.bfloat16),
                                          qs.data_ptr(), sx.data_ptr(), out.data_ptr(), m, k,
                                          qs.shape[1], stream()))
        return out

    def old_i8p(a_sbi, a_s, qs, f8, e2):
        m, k = a_sbi.shape
        n = qs.shape[1]
        out_bf16 = tm.i8p_out_bf16(m)
        out = torch.empty((m, n), dtype=torch.bfloat16 if out_bf16 else torch.float32,
                          device=dev)
        _checked(old_lib.rrs_tcq4_i8p(a_sbi.data_ptr(), a_s.data_ptr(), qs.data_ptr(),
                                      f8.data_ptr(), e2.data_ptr(), out.data_ptr(), m, k, n,
                                      int(out_bf16), stream()))
        return out

    def old_mx_all(a, qs_all, s_all):
        e_n, _, n = qs_all.shape
        t, k = a.shape[-2:]
        out = torch.empty((e_n, t, n), dtype=torch.float32, device=dev)
        _checked(old_lib.rrs_mxfp4_all_experts(a.data_ptr(), int(a.dim() == 3),
                                               qs_all.data_ptr(), s_all.data_ptr(),
                                               out.data_ptr(), e_n, t, k, n, stream()))
        return out

    def old_tq_all(a, qs_all, eff_all):
        e_n, _, n = qs_all.shape
        t, k = a.shape[-2:]
        out = torch.empty((e_n, t, n), dtype=torch.float32, device=dev)
        _checked(old_lib.rrs_tcq4_all_experts(a.data_ptr(), int(a.dtype == torch.bfloat16),
                                              int(a.dim() == 3), qs_all.data_ptr(),
                                              eff_all.data_ptr(), out.data_ptr(), e_n, t, k, n,
                                              stream()))
        return out

    def old_mx_rows(a, qs_all, s_all, ids):
        n_sel, k = a.shape
        e_n, _, n = qs_all.shape
        out = torch.empty((n_sel, n), dtype=torch.float32, device=dev)
        _checked(old_lib.rrs_mxfp4_rows(a.data_ptr(), qs_all.data_ptr(), s_all.data_ptr(),
                                        ids.data_ptr(), out.data_ptr(), n_sel, k, n, e_n,
                                        stream()))
        return out

    def old_tq_rows(a, qs_all, eff_all, ids):
        n_sel, k = a.shape
        e_n, _, n = qs_all.shape
        out = torch.empty((n_sel, n), dtype=torch.float32, device=dev)
        _checked(old_lib.rrs_tcq4_experts_rows(a.data_ptr(), int(a.dtype == torch.bfloat16),
                                               qs_all.data_ptr(), eff_all.data_ptr(),
                                               ids.data_ptr(), out.data_ptr(), n_sel, k, n, e_n,
                                               stream()))
        return out

    def old_gx2(a, qs, eff):
        m, k = a.shape
        out = torch.empty((m, qs.shape[1]), dtype=torch.float32, device=dev)
        _checked(old_lib.rrs_tcq4_gx2(a.data_ptr(), qs.data_ptr(), eff.data_ptr(),
                                      out.data_ptr(), m, k, qs.shape[1], stream()))
        return out

    def old_gx3(x, qs, eff):
        m, k = x.shape
        out = torch.empty((m, qs.shape[1]), dtype=torch.float32, device=dev)
        _checked(old_lib.rrs_tcq4_gx3(x.data_ptr(), int(x.dtype == torch.bfloat16),
                                      qs.data_ptr(), eff.data_ptr(), out.data_ptr(), m, k,
                                      qs.shape[1], stream()))
        return out

    def old_pb(a_gi, ag24, qs_gi, eff):
        m, k = a_gi.shape
        out = torch.empty((m, qs_gi.shape[1]), dtype=torch.float32, device=dev)
        _checked(old_lib.rrs_tcq4_pb(a_gi.data_ptr(), ag24.data_ptr(), qs_gi.data_ptr(),
                                     eff.data_ptr(), out.data_ptr(), m, k, qs_gi.shape[1],
                                     stream()))
        return out

    def old_a8(a_q, a_s, qs, eff):
        m, k = a_q.shape
        out = torch.empty((m, qs.shape[1]), dtype=torch.float32, device=dev)
        _checked(old_lib.rrs_tcq4_a8(a_q.data_ptr(), a_s.data_ptr(), qs.data_ptr(),
                                     eff.data_ptr(), out.data_ptr(), m, k, qs.shape[1], stream()))
        return out

    return {"tcq4": old_tcq4, "q8": old_q8, "mx": old_mx, "i8p": old_i8p,
            "mx_all": old_mx_all, "tq_all": old_tq_all, "mx_rows": old_mx_rows,
            "tq_rows": old_tq_rows, "gx2": old_gx2, "gx3": old_gx3, "pb": old_pb,
            "a8": old_a8}


def run_b2_b4(old: dict, same_bits: bool = False) -> list[dict]:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    rows: list[dict] = []
    old_tcq4, old_q8 = old["tcq4"], old["q8"]

    print("B4 tcq4_matmul, qwen3-4b (phase 2 shapes, and down at M = 2, 8)", flush=True)
    for lname, (k, n) in QWEN3_4B.items():
        wbytes = k // 2 * n + k // 32 * n * 2
        ws = [(torch.randint(0, 256, (k // 2, n), generator=gen, device=dev, dtype=torch.uint8),
               (torch.rand((k // 32, n), generator=gen, device=dev) * 0.01 + 0.001
                ).to(torch.bfloat16)) for _ in range(n_copies(wbytes))]
        wl = [tm.dequantize_w(*w).to(torch.bfloat16) for w in ws[:n_copies(2 * k * n)]]
        for m in ((2, 4, 8, 16, 64, 512) if lname == "down" else (4, 16, 64, 512)):
            a = (torch.randint(-7, 8, (m, k), generator=gen, device=dev).float()
                 * (torch.rand((m, 1), generator=gen, device=dev) + 0.5) / 7.0)
            a16 = a.to(torch.bfloat16)
            ab(f"tcq4 {lname} M={m} K={k} N={n}", old_tcq4, tm.tcq4_matmul, tm.tcq4_matmul_plain,
               lambda w: torch.matmul(a16, w), [(a, q, e) for q, e in ws], [(w,) for w in wl],
               wbytes + m * k * 4 + m * n * 4, 2 * m * k * n, 20, 1e-3, rows,
               same_bits=same_bits)
        del ws, wl
        torch.cuda.empty_cache()

    print("B2 q8_matmul (phase 2: qwen3-4b lm_head; phase 10: gpt-oss-20b)", flush=True)
    shapes = [("qwen3-4b lm_head", 2560, 153600, (1, 4, 64))]
    shapes += [(f"gpt-oss {n_}", k, n, (1, 4, 2048) if n_ != "lm_head" else (1,))
               for n_, (k, n) in GPTOSS_Q8.items()]
    for lname, k, n, ms_ in shapes:
        wbytes = k * n + k // 32 * n * 4
        qw = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
        sc = 2.0 ** torch.randint(-11, -9, (k // 32, n), generator=gen, device=dev).float()
        wl = (qw.float().reshape(k // 32, 32, n) * sc[:, None]).reshape(k, n).to(torch.bfloat16)
        ws = [(qw, sc)] + [(qw.clone(), sc.clone()) for _ in range(n_copies(wbytes) - 1)]
        wls = [wl] + [wl.clone() for _ in range(n_copies(2 * k * n) - 1)]
        for m in ms_:
            a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            ab(f"q8 {lname} M={m} K={k} N={n}", lambda q_, s_: old_q8(a, q_, s_),
               lambda q_, s_: q8.q8_matmul(a, q_, s_), lambda q_, s_: q8.q8_matmul_plain(a, q_, s_),
               lambda w: torch.matmul(a, w), ws, [(w,) for w in wls],
               wbytes + m * k * 2 + m * n * 4, 2 * m * k * n, 20 if m < 2048 else 5, 1e-3, rows,
               same_bits=same_bits)
        del qw, sc, wl, ws, wls
        torch.cuda.empty_cache()
    return rows


def run_b11(old: dict, same_bits: bool = False) -> list[dict]:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    rows: list[dict] = []
    old_mx = old["mx"]

    print("B11 mxfp4_matmul, one gpt-oss-20b expert projection", flush=True)
    k, n = 2880, 2944
    wbytes = k // 2 * n + k // 32 * n
    ws = [(torch.randint(0, 256, (k // 2, n), generator=gen, device=dev, dtype=torch.uint8),
           torch.randint(118, 123, (k // 32, n), generator=gen, device=dev, dtype=torch.uint8))
          for _ in range(n_copies(wbytes))]
    wl = [mx.dequant_mxfp4(*w).to(torch.bfloat16) for w in ws[:n_copies(2 * k * n)]]
    for m in (4, 300, 2048):
        a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        ab(f"mxfp4 M={m} K={k} N={n}", lambda q_, s_: old_mx(a, q_, s_),
           lambda q_, s_: mx.mxfp4_matmul(a, q_, s_),
           lambda q_, s_: mx.mxfp4_matmul_plain(a, q_, s_),
           lambda w: torch.matmul(a, w), ws, [(w,) for w in wl],
           wbytes + m * k * 2 + m * n * 4, 2 * m * k * n, 20 if m < 2048 else 10, 1e-3, rows,
           same_bits=same_bits)
    del ws, wl
    torch.cuda.empty_cache()
    return rows


def run_b5(old: dict) -> list[dict]:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    rows: list[dict] = []
    old_i8p = old["i8p"]

    print("B5 tcq4_matmul_i8p, qwen3-4b projections", flush=True)
    for lname, (k, n) in QWEN3_4B.items():
        pbytes = k // 2 * n + k // 32 * n + k // 256 * n * 4
        ws = [(torch.randint(0, 256, (k // 2, n), generator=gen, device=dev, dtype=torch.uint8),
               (torch.rand((k // 32, n), generator=gen, device=dev) * 0.01 + 0.001
                ).to(torch.bfloat16)) for _ in range(n_copies(pbytes))]
        packs = [tm.pack_i8p(q, e) for q, e in ws]
        wl = [tm.dequantize_w(*w).to(torch.bfloat16) for w in ws[:n_copies(2 * k * n)]]
        w8 = [tm.decode_w8(*pk[:2]).to(torch.int8).t().contiguous().t()
              for pk in packs[:n_copies(k * n)]]
        for m in (256, 512, 4096):
            a_q = torch.randint(-7, 8, (m, k), generator=gen, device=dev, dtype=torch.int8)
            a_s = torch.rand((m, k // 256), generator=gen, device=dev) + 0.5
            a_sbi = tm.prep_a_sbi(a_q)
            a16 = (a_q.float() * a_s.repeat_interleave(256, dim=1) / 7.0).to(torch.bfloat16)
            out_bytes = m * n * (2 if tm.i8p_out_bf16(m) else 4)
            ab(f"i8p {lname} M={m} K={k} N={n}", lambda *pk: old_i8p(a_sbi, a_s, *pk),
               lambda *pk: tm.tcq4_matmul_i8p(a_sbi, a_s, *pk),
               lambda *pk: tm.tcq4_matmul_i8p_plain(a_sbi, a_s, *pk),
               lambda w: torch.matmul(a16, w), packs, [(w,) for w in wl],
               pbytes + m * k + m * k // 256 * 4 + out_bytes, 2 * m * k * n,
               20 if m < 4096 else 5, 8e-3 if tm.i8p_out_bf16(m) else 1e-5, rows,
               peak=INT8_OPS, extra={"int_mm": (torch._int_mm, [(a_sbi, w) for w in w8])})
        del ws, packs, wl, w8
        torch.cuda.empty_cache()
    for m in (256, 512, 4096):
        sel = [r for r in rows if r["shape"].startswith("i8p") and f" M={m} " in r["shape"]]
        tot = {key: sum(r[key] for r in sel)
               for key in ("old_ms", "new_ms", "library_ms", "int_mm_ms", "bound_ms")}
        rows.append({"shape": f"i8p four projections summed M={m}", **tot})
        print(f"  i8p four summed M={m}: old {tot['old_ms']:.4f} new {tot['new_ms']:.4f} "
              f"library {tot['library_ms']:.4f} int_mm {tot['int_mm_ms']:.4f} "
              f"bound {tot['bound_ms']:.4f}", flush=True)
    return rows


def run_b13_b10(old: dict) -> list[dict]:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    rows: list[dict] = []

    def shapes(e_n, k, n, wbytes, stacks, w16, new, plain, old_fn, cases, label):
        for case, shape in cases:
            a = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            t = shape[-2]
            lib = (lambda w: torch.matmul(a, w)) if a.dim() == 2 else (lambda w: torch.bmm(a, w))
            ab(f"{label} {case} K={k} N={n} E={e_n}", lambda q_, e_: old_fn(a, q_, e_),
               lambda q_, e_: new(a, q_, e_), lambda q_, e_: plain(a, q_, e_), lib, stacks,
               [(w,) for w in w16], e_n * wbytes + a.numel() * 2 + e_n * t * n * 4,
               2 * e_n * t * k * n, 10, 1e-3, rows)

    print("B10 tcq4_matmul_all_experts, Qwen3-30B-A3B (E = 128)", flush=True)
    for proj, (k, n) in (("gate_up", (2048, 768)), ("down", (768, 2048))):
        e_n, wbytes = 128, k // 2 * n + k // 32 * n * 2
        stacks = [(torch.randint(0, 256, (e_n, k // 2, n), generator=gen, device=dev,
                                 dtype=torch.uint8),
                   (torch.rand((e_n, k // 32, n), generator=gen, device=dev) * 0.01 + 0.001
                    ).to(torch.bfloat16)) for _ in range(n_copies(e_n * wbytes))]
        w16 = [torch.stack([tm.dequantize_w(q[i], e[i]).to(torch.bfloat16) for i in range(e_n)])
               for q, e in stacks[:n_copies(2 * e_n * k * n)]]
        shapes(e_n, k, n, wbytes, stacks, w16, tm.tcq4_matmul_all_experts,
               tm.tcq4_matmul_all_experts_plain, old["tq_all"],
               (("per-expert C=64", (e_n, 64, k)), ("shared T=64", (64, k))), f"tcq4 {proj}")
        del stacks, w16
        torch.cuda.empty_cache()

    print("B13 mxfp4_matmul_all_experts, gpt-oss-20b (E = 32)", flush=True)
    e_n, k, n = 32, 2880, 2944
    wbytes = k // 2 * n + k // 32 * n
    stacks = [(torch.randint(0, 256, (e_n, k // 2, n), generator=gen, device=dev,
                             dtype=torch.uint8),
               torch.randint(118, 123, (e_n, k // 32, n), generator=gen, device=dev,
                             dtype=torch.uint8)) for _ in range(n_copies(e_n * wbytes))]
    w16 = [mx.dequant_mxfp4(*w).to(torch.bfloat16) for w in stacks[:n_copies(2 * e_n * k * n)]]
    shapes(e_n, k, n, wbytes, stacks, w16, mx.mxfp4_matmul_all_experts,
           mx.mxfp4_matmul_all_experts_plain, old["mx_all"],
           (("shared T=64", (64, k)), ("per-expert C=128", (e_n, 128, k))), "mxfp4")
    del stacks, w16
    torch.cuda.empty_cache()
    return rows


def run_b12_b9(old: dict) -> list[dict]:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    rows: list[dict] = []

    def shapes(label, e_n, k, n, top_k, stacks, exp_bytes, w16_all, new, plain, old_fn, plan,
               n_sels):
        for n_sel in n_sels:
            a = torch.randn((n_sel, k), generator=gen, device=dev).to(torch.bfloat16)
            id_sets = rotating_ids(e_n, n_sel // top_k, top_k, n_copies(n_sel * exp_bytes), gen)
            gathered = [w16_all[ids.long()] for ids in id_sets[:n_copies(n_sel * k * n * 2)]]
            distinct = int(torch.unique(id_sets[0]).numel())
            ab(f"{label} n_sel={n_sel} K={k} N={n} E={e_n} ({distinct} experts; "
               f"{plan(n_sel, k, n).slices} K slices)",
               lambda i: old_fn(a, *stacks, i), lambda i: new(a, *stacks, i),
               lambda i: plain(a, *stacks, i), lambda w: torch.bmm(a[:, None, :], w),
               [(i,) for i in id_sets], [(w,) for w in gathered],
               distinct * exp_bytes + n_sel * k * 2 + n_sel * 4 + n_sel * n * 4,
               2 * n_sel * k * n, 40, 1e-3, rows, self_bits=True)
            del gathered

    print("B9 tcq4_matmul_experts_rows, Qwen3-30B-A3B (E = 128, top-8)", flush=True)
    for proj, (k, n) in (("gate/up", (2048, 768)), ("down", (768, 2048))):
        e_n, exp_bytes = 128, k // 2 * n + k // 32 * n * 2
        stacks = (torch.randint(0, 256, (e_n, k // 2, n), generator=gen, device=dev,
                                dtype=torch.uint8),
                  (torch.rand((e_n, k // 32, n), generator=gen, device=dev) * 0.01 + 0.001
                   ).to(torch.bfloat16))
        w16_all = torch.stack([tm.dequantize_w(stacks[0][e], stacks[1][e]).to(torch.bfloat16)
                               for e in range(e_n)])
        shapes(f"tcq4 rows {proj}", e_n, k, n, 8, stacks, exp_bytes, w16_all,
               tm.tcq4_matmul_experts_rows, tm.tcq4_matmul_experts_rows_plain, old["tq_rows"],
               tm.rows_plan, (8, 32, 128))
        del stacks, w16_all
        torch.cuda.empty_cache()

    print("B12 mxfp4_matmul_experts_rows, gpt-oss-20b (E = 32, top-4)", flush=True)
    e_n, k, n = 32, 2880, 2944
    stacks = (torch.randint(0, 256, (e_n, k // 2, n), generator=gen, device=dev,
                            dtype=torch.uint8),
              torch.randint(118, 123, (e_n, k // 32, n), generator=gen, device=dev,
                            dtype=torch.uint8))
    w16_all = mx.dequant_mxfp4(*stacks).to(torch.bfloat16)
    shapes("mxfp4 rows", e_n, k, n, 4, stacks, k // 2 * n + k // 32 * n, w16_all,
           mx.mxfp4_matmul_experts_rows, mx.mxfp4_matmul_experts_rows_plain, old["mx_rows"],
           mx.rows_plan, (4, 16, 64))
    del stacks, w16_all
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def gx_slices_forced(slices: int, plan: str = "gx_plan"):
    """The wrappers that take ``tcq4_matmul.<plan>`` (``gx_plan``: B1, B14,
    B15; ``a8_plan``: B16; ``splitk_plan``: B4, B17, B18) launched with K in
    ``slices`` even slices of whole superblocks while open (the plan
    replaced; the split-K bodies of gemm_sm90.cuh get their scratch)."""
    saved = getattr(tm, plan)

    def forced(m: int, k: int, n: int) -> splitk.Plan:
        strips, units = -(-n // splitk.STRIP), k // tm.TILE_K
        per = -(-units // slices)
        s = -(-units // per)
        scratch = s * m * strips * splitk.STRIP if s > 1 and plan == "splitk_plan" else 0
        return splitk.Plan(strips, s, per, scratch)

    setattr(tm, plan, forced)
    try:
        yield
    finally:
        setattr(tm, plan, saved)


def gx_shapes():
    """(label, M, K, N) of the b1,b15 subject: qwen3-4b's four projections at
    M = 1, qkv / o / gate_up at M = 4 and 8 (down is outside gx_viable
    there), Qwen3-30B-A3B's attention projections at M = 1."""
    shapes = [(name, 1, k, n) for name, (k, n) in QWEN3_4B.items()]
    shapes += [(name, m, k, n) for m in (4, 8) for name, (k, n) in QWEN3_4B.items()
               if tm.gx_viable(m, k, n)]
    return shapes + [(name, 1, k, n) for name, (k, n) in QWEN3_30B_ATTN.items()]


def run_b1_b15(old: dict, same_bits: bool = False) -> list[dict]:
    """B1 and B15 at ``gx_shapes``, each held to its plain version and the
    parent (rel 1e-5), to itself across two launches, and B1 at M = 1 bit
    for bit to ``tcq4_matmul_gx_splitk_plain`` (the kernel's order of sums);
    timed in turns beside ``torch.matmul`` on bf16 weights, the read floor,
    a library reduction (``view(torch.int32).sum()``, and ``view(torch.
    float32).sum()``) over uint8 buffers of the weights' byte count, all
    rotated past L2, and the launch floor, a one-element ``add_``. Then the K
    slice sweep of B1 at each shape: every even split into 1 .. K/256
    slices that the kernel takes (at most ``splitk.GX_MAX_SLICES``, a
    cluster's blocks, of at most ``splitk.GX_MAX_TASKS`` / M superblocks),
    held to plain and timed, beside the slice count ``gx_plan`` picks. With
    ``same_bits`` (a parent with this tree's gx entries): B14 on B1's codes
    too, every output bit for bit the parent's, and no sweep."""
    from rrs_tpu_torch.formats.tcq4 import quantize_activations_rrs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    rows: list[dict] = []
    sweeps: list[dict] = []
    print("B1 tcq4_matmul_gx2 and B15 tcq4_matmul_gx3 (bf16 x), qwen3-4b and Qwen3-30B-A3B",
          flush=True)
    for label, m, k, n in gx_shapes():
        wbytes = k // 2 * n + k // 32 * n * 2
        ws = [(torch.randint(0, 256, (k // 2, n), generator=gen, device=dev, dtype=torch.uint8),
               (torch.rand((k // 32, n), generator=gen, device=dev) * 0.01 + 0.001
                ).to(torch.bfloat16)) for _ in range(n_copies(wbytes))]
        wl = [tm.dequantize_w(*w).to(torch.bfloat16) for w in ws[:n_copies(2 * k * n)]]
        floor = [torch.randint(0, 256, (wbytes // 4 * 4,), generator=gen, device=dev,
                               dtype=torch.uint8) for _ in range(n_copies(wbytes))]
        tiny = torch.zeros((1,), device=dev)
        extra = {"read_floor": (lambda b: b.view(torch.int32).sum(), [(b,) for b in floor]),
                 "read_floor_f32": (lambda b: b.view(torch.float32).sum(), [(b,) for b in floor]),
                 "launch_floor": (lambda t: t.add_(1.0), [(tiny,)])}
        a = torch.randn((m, k), generator=gen, device=dev)
        x = a.to(torch.bfloat16)
        plan = tm.gx_plan(m, k, n)
        if m == 1:
            a_q, a_s = quantize_activations_rrs(a)
            got = tm.tcq4_matmul_gx2(a, *ws[0])
            if not torch.equal(got, tm.tcq4_matmul_gx_splitk_plain(a_q, a_s, *ws[0], plan)):
                raise AssertionError(f"gx2 {label} M={m}: not the kernel order's bits")
        shape = f"{label} M={m} K={k} N={n} ({plan.slices} K slices)"
        kinds = [("gx2", tm.tcq4_matmul_gx2, tm.tcq4_matmul_gx2_plain, old["gx2"], (a,)),
                 ("gx3 bf16 x", tm.tcq4_matmul_gx3, tm.tcq4_matmul_gx3_plain, old["gx3"], (x,))]
        if same_bits:
            kinds.append(("gx", tm.tcq4_matmul_gx, tm.tcq4_matmul_gx_plain, old["gx"],
                          quantize_activations_rrs(a)))
        for kind, new, plain, old_fn, act in kinds:
            ab(f"{kind} {shape}", lambda q_, e_: old_fn(*act, q_, e_),
               lambda q_, e_: new(*act, q_, e_), lambda q_, e_: plain(*act, q_, e_),
               lambda w: torch.matmul(x, w), ws, [(w,) for w in wl],
               wbytes + sum(t.numel() * t.element_size() for t in act) + m * n * 4,
               2 * m * k * n, 40, 1e-5, rows, peak=INT8_OPS, extra=extra, self_bits=True,
               same_bits=same_bits)
        if same_bits:
            del ws, wl, floor
            torch.cuda.empty_cache()
            continue
        units, times = k // tm.TILE_K, {}
        ref = tm.tcq4_matmul_gx2_plain(a, *ws[0])
        fits = (lambda c: c <= splitk.GX_MAX_SLICES                      # noqa: E731
                and m * -(-units // c) <= splitk.GX_MAX_TASKS)
        for s in sorted({c for c in (-(-units // per) for per in range(1, units + 1)) if fits(c)}):
            with gx_slices_forced(s):
                r = rel(tm.tcq4_matmul_gx2(a, *ws[0]), ref)
                if not r <= 1e-5:
                    raise AssertionError(f"gx2 {label} M={m} {s} slices: rel {r:.2e}")
                times[s] = time_ms(tm.tcq4_matmul_gx2, [(a, q, e) for q, e in ws], 40)
        sweeps.append({"shape": f"sweep gx2 {label} M={m} K={k} N={n}", "strips": plan.strips,
                       "ms_by_slices": times, "gx_plan_slices": plan.slices})
        print(f"  sweep gx2 {label} M={m} ({plan.strips} strips): slices -> ms: " +
              ", ".join(f"{s} {t:.4f}{' *' if s == plan.slices else ''}"
                        for s, t in times.items()) + "  (* gx_plan)", flush=True)
        del ws, wl, floor
        torch.cuda.empty_cache()
    for kind in ("gx2", "gx3 bf16 x") + (("gx",) if same_bits else ()):
        sel = [r for r in rows if r["shape"].startswith(kind + " ") and " M=1 " in r["shape"]
               and "30b" not in r["shape"]]
        tot = {key: sum(r[key] for r in sel)
               for key in ("old_ms", "new_ms", "library_ms", "read_floor_ms",
                           "read_floor_f32_ms", "launch_floor_ms", "bound_ms")}
        rows.append({"shape": f"{kind} qwen3-4b four projections summed M=1", **tot})
        print(f"  {kind} four summed M=1: old {tot['old_ms']:.4f} new {tot['new_ms']:.4f} "
              f"library {tot['library_ms']:.4f} read floor {tot['read_floor_ms']:.4f} / "
              f"{tot['read_floor_f32_ms']:.4f} launch floor {tot['launch_floor_ms']:.4f} "
              f"bound {tot['bound_ms']:.4f}", flush=True)
    return rows + sweeps


def summed(rows: list[dict], prefix: str, m: int, keys=("old_ms", "new_ms", "library_ms",
                                                         "bound_ms")) -> dict:
    """The qwen3-4b rows of ``prefix`` at M = m summed over the four
    projections; printed."""
    sel = [r for r in rows if r["shape"].startswith(prefix + " ") and f" M={m} " in r["shape"]
           and "30b" not in r["shape"]]
    tot = {key: sum(r[key] for r in sel) for key in keys}
    print(f"  {prefix} four summed M={m}: " + " ".join(f"{key[:-3]} {v:.4f}"
                                                      for key, v in tot.items()), flush=True)
    return {"shape": f"{prefix} qwen3-4b four projections summed M={m}", **tot}


def sweep(label: str, plan: str, counts, call, arg_sets, ref, tol: float, picked: int,
          reps: int) -> dict:
    """``call`` timed under each K-slice count in ``counts`` (the plan
    ``plan`` forced), each output held to ``ref`` within ``tol``; printed
    beside the plan's pick."""
    times = {}
    for s in counts:
        with gx_slices_forced(s, plan):
            r = rel(call(*arg_sets[0]), ref)
            if not r <= tol:
                raise AssertionError(f"{label} {s} slices: rel {r:.2e}")
            times[s] = time_ms(call, arg_sets, reps)
    print(f"  sweep {label}: slices -> ms: " + ", ".join(
        f"{s} {t:.4f}{' *' if s == picked else ''}" for s, t in times.items()) + "  (* the plan)",
        flush=True)
    return {"shape": f"sweep {label}", "ms_by_slices": times, "plan_slices": picked}


def even_counts(units: int, fits) -> list[int]:
    return sorted({c for c in (-(-units // per) for per in range(1, units + 1)) if fits(c)})


def run_b18_b16(old: dict) -> list[dict]:
    """B18 at the four qwen3-4b projections, M = 1, 16 and 512, and B16 at M
    = 1, 8 and 32, both also at Qwen3-30B-A3B's qkv / o at M = 1: each held
    to its plain version (1e-3 for B18's bf16 operands, 1e-5 for B16), to
    the parent and to itself across two launches, B16 also bit for bit to
    ``tcq4_matmul_a8_splitk_plain`` (its order of sums); timed in turns
    beside ``torch.matmul`` on bf16 weights dequantized beforehand, kernel
    and library operands rotated past L2; B18 on random activations through
    ``pb_prepare``, B16 on random codes. Then the K-slice sweeps: B18 at M =
    1 (``splitk_plan``), B16 at M = 1, 8 and 32 (``a8_plan``)."""
    from rrs_tpu_torch.formats.tcq4 import dequantize_activations_rrs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    rows: list[dict] = []
    sweeps: list[dict] = []
    print("B18 tcq4_matmul_pb and B16 tcq4_matmul_a8, qwen3-4b and Qwen3-30B-A3B", flush=True)
    for lname, (k, n) in {**QWEN3_4B, **QWEN3_30B_ATTN}.items():
        g = k // 32
        wbytes = k // 2 * n + g * n * 2
        ws = [(torch.randint(0, 256, (k // 2, n), generator=gen, device=dev, dtype=torch.uint8),
               (torch.rand((g, n), generator=gen, device=dev) * 0.01 + 0.001
                ).to(torch.bfloat16)) for _ in range(n_copies(wbytes))]
        gis = [(tm.pack_gi(q), e) for q, e in ws]
        ws32 = [(q, e.float()) for q, e in ws[:n_copies(wbytes + g * n * 2)]]
        wl = [tm.dequantize_w(*w).to(torch.bfloat16) for w in ws[:n_copies(2 * k * n)]]
        units = k // tm.TILE_K
        for m in ((1,) if "30b" in lname else (1, 16, 512)):
            a = torch.randn((m, k), generator=gen, device=dev) * 0.5
            a_gi, ag24 = tm.pb_prepare(a)
            a16 = a.to(torch.bfloat16)
            plan = tm.splitk_plan(m, k, n)
            call = lambda q_, e_: tm.tcq4_matmul_pb(a_gi, ag24, q_, e_)      # noqa: E731
            ab(f"pb {lname} M={m} K={k} N={n} ({plan.slices} K slices)",
               lambda q_, e_: old["pb"](a_gi, ag24, q_, e_), call,
               lambda q_, e_: tm.tcq4_matmul_pb_plain(a_gi, ag24, q_, e_),
               lambda w: torch.matmul(a16, w), gis, [(w,) for w in wl],
               wbytes + m * k * 2 + m * 2 * g * 2 + m * n * 4, 2 * m * k * n + 2 * m * 2 * g * n,
               40 if m < 512 else 10, 1e-3, rows, self_bits=True)
            if m == 1:
                sweeps.append(sweep(f"pb {lname} M=1 K={k} N={n}", "splitk_plan",
                                    even_counts(units, lambda c: True), call, gis,
                                    tm.tcq4_matmul_pb_plain(a_gi, ag24, *gis[0]), 1e-3,
                                    plan.slices, 40))
        for m in ((1,) if "30b" in lname else (1, 8, 32)):
            a_q = torch.randint(-7, 8, (m, k), generator=gen, device=dev, dtype=torch.int8)
            a_s = torch.rand((m, k // 256), generator=gen, device=dev) + 0.5
            a16 = dequantize_activations_rrs(a_q, a_s).to(torch.bfloat16)
            plan = tm.a8_plan(m, k, n)
            call = lambda q_, e_: tm.tcq4_matmul_a8(a_q, a_s, q_, e_)        # noqa: E731
            if not torch.equal(call(*ws32[0]), tm.tcq4_matmul_a8_splitk_plain(a_q, a_s, *ws32[0],
                                                                              plan)):
                raise AssertionError(f"a8 {lname} M={m}: not the kernel order's bits")
            ab(f"a8 {lname} M={m} K={k} N={n} ({plan.slices} K slices)",
               lambda q_, e_: old["a8"](a_q, a_s, q_, e_), call,
               lambda q_, e_: tm.tcq4_matmul_a8_plain(a_q, a_s, q_, e_),
               lambda w: torch.matmul(a16, w), ws32, [(w,) for w in wl],
               k // 2 * n + g * n * 4 + m * k + m * (k // 256) * 4 + m * n * 4, 2 * m * k * n,
               40, 1e-5, rows, peak=INT8_OPS, self_bits=True)
            fits = (lambda c: c <= splitk.GX_MAX_SLICES                     # noqa: E731
                    and splitk.gx_smem(m, -(-units // c), 4, 0) <= splitk.GX_MAX_SMEM)
            sweeps.append(sweep(f"a8 {lname} M={m} K={k} N={n}", "a8_plan",
                                even_counts(units, fits), call, ws32,
                                tm.tcq4_matmul_a8_plain(a_q, a_s, *ws32[0]), 1e-5, plan.slices,
                                40))
        del ws, gis, ws32, wl
        torch.cuda.empty_cache()
    rows += [summed(rows, "pb", m) for m in (1, 16, 512)]
    rows += [summed(rows, "a8", m) for m in (1, 8, 32)]
    return rows + sweeps


RUNS = {"b2,b4": lambda old: run_b2_b4(old),
        "b11,b5": lambda old: run_b11(old) + run_b5(old),
        "b13,b10": run_b13_b10,
        "b12,b9": run_b12_b9,
        "b2,b4,b11": lambda old: run_b2_b4(old, same_bits=True) + run_b11(old, same_bits=True),
        "b1,b15": run_b1_b15,
        "b1,b14,b15": lambda old: run_b1_b15(old, same_bits=True),
        "b18,b16": run_b18_b16}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path, help="an older tree of this repo")
    ap.add_argument("--subjects", choices=sorted(SUBJECTS), default="b11,b5",
                    help="the kernels to hold and time (the parent must predate their redesign)")
    ap.add_argument("--json", type=Path, help="write the rows here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gemm_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}; {smi}", flush=True)
    kernels.lib()
    sources, signatures = SUBJECTS[args.subjects]
    old_lib = build_old(args.parent, sources=sources, signatures=signatures)
    rows = compare_sass(args.parent, sources) if args.subjects in SASS_SUBJECTS else []
    rows += RUNS[args.subjects](old_calls(old_lib, args.subjects))
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"device": smi, "subjects": args.subjects, "rows": rows},
                                        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
