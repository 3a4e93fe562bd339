"""Whether integer or floating-point work overlaps with ``mma.sync`` on the
card: the question behind the prefill kernels' budgets (B4, B5, B11).

    python3 -m rrs_tpu_torch.tools.mma_overlap [--json OUT]

One block an SM of 12 warps: 8 run the int8 MMA loop of B5's body
(``csrc/tcq4_i8p.cu``: ldmatrix-fed m16n8k32 s8, warp tile 64 x 32, out of
shared memory), 4 run independent chains of half2 (B5's weight decode), of
integer prmt / lop3 / imad, or of f32 multiplies and adds (B5's epilogue).
Each kind is timed alone and beside the MMA warps with CUDA events; where the
pair takes the sum of the two, the work does not overlap. Needs one CUDA card
and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

from rrs_tpu_torch import kernels

SOURCE = r"""
#include <cstdio>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
               "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// MODE bit 0: the MMA warps work; bits 1-3: the other warps run half2,
// integer or f32 chains.
template <int MODE>
__global__ void __launch_bounds__(384, 1) probe(int* out, int iters, int alu_iters) {
  extern __shared__ __align__(128) unsigned char sm[];
  for (int i = threadIdx.x; i < 65536 / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(sm)[i] = i * 2654435761u;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int res = 0;
  if (warp < 8) {
    if (MODE & 1) {
      const int wm = warp >> 2, wn = warp & 3;
      int p[4][4][4] = {};
      for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          uint32_t af[4][4], bf[2][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = wm * 64 + i * 16 + (lane & 15);
            ldsm(af[i], sm + r * 256 + (((2 * ks + (lane >> 4)) ^ (r & 7)) * 16));
          }
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int n = wn * 32 + jj * 16 + (lane >> 4) * 8 + (lane & 7);
            ldsm(bf[jj], sm + 32768 + n * 256 +
                             (((2 * ks + ((lane >> 3) & 1)) ^ ((n ^ (n >> 3)) & 7)) * 16));
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma(p[i][j], af[i], bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1]);
        }
      }
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) res += p[i][j][0] + p[i][j][1] + p[i][j][2] + p[i][j][3];
    }
  } else if (MODE & 2) {
    __half2 z[8];
    for (int q = 0; q < 8; ++q) z[q] = __floats2half2_rn(0.001f * (lane + q), 0.002f * q);
    const __half2 a = __float2half2_rn(0.999f), b = __float2half2_rn(0.0001f);
    for (int it = 0; it < alu_iters; ++it) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uint32_t x = *reinterpret_cast<uint32_t*>(&z[q]);
        x = __byte_perm(x, x ^ 0x00080008u, 0x5140);
        const __half2 w = __hsub2(*reinterpret_cast<__half2*>(&x), b);
        z[q] = __hfma2(__hfma2(w, a, b), a, z[q]);
      }
    }
    for (int q = 0; q < 8; ++q) res += *reinterpret_cast<int*>(&z[q]);
  } else if (MODE & 4) {
    uint32_t z[8];
    for (int q = 0; q < 8; ++q) z[q] = lane * 2654435761u + q;
    for (int it = 0; it < alu_iters; ++it) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uint32_t x = __byte_perm(z[q], z[q] >> 4, 0x5140);
        x = (x & 0x000F000Fu) | 0x64006400u;
        z[q] = x * 3u + (z[q] ^ 0x88888888u);
      }
    }
    for (int q = 0; q < 8; ++q) res += z[q];
  } else if (MODE & 8) {
    float z[8];
    for (int q = 0; q < 8; ++q) z[q] = 0.001f * (lane + q);
    for (int it = 0; it < alu_iters; ++it) {
#pragma unroll
      for (int q = 0; q < 8; ++q) z[q] = __fadd_rn(__fmul_rn(z[q], 0.999f), __fmul_rn(z[q], 1e-4f));
    }
    for (int q = 0; q < 8; ++q) res += __float_as_int(z[q]);
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = res;
}

template <int MODE>
float run(int* o, int sms, int iters, int alu_iters) {
  cudaFuncSetAttribute(probe<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536);
  probe<MODE><<<sms, 384, 65536>>>(o, 2, 2);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  probe<MODE><<<sms, 384, 65536>>>(o, iters, alu_iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms;
}

int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  int* o;
  cudaMalloc(&o, sms * 384 * 4);
  const int iters = 1000;
  for (int alu : {4000, 8000}) {
    const float m = run<1>(o, sms, iters, alu);
    const double tops = 2.0 * 16 * 8 * 32 * 16 * 8 * double(iters) * sms * 8 / m / 1e9;
    printf("{\"alu_iters\": %d, \"mma_ms\": %.4f, \"mma_tops\": %.1f, "
           "\"half2_ms\": %.4f, \"half2_with_mma_ms\": %.4f, "
           "\"int_ms\": %.4f, \"int_with_mma_ms\": %.4f, "
           "\"f32_ms\": %.4f, \"f32_with_mma_ms\": %.4f}\n",
           alu, m, tops, run<2>(o, sms, iters, alu), run<3>(o, sms, iters, alu),
           run<4>(o, sms, iters, alu), run<5>(o, sms, iters, alu), run<8>(o, sms, iters, alu),
           run<9>(o, sms, iters, alu));
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    fprintf(stderr, "%s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=Path, help="write the rows here")
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    tmp = Path(tempfile.mkdtemp(prefix="mma_overlap_"))
    (tmp / "probe.cu").write_text(SOURCE)
    subprocess.run([kernels._nvcc(), kernels.ARCH, "-std=c++17", "-O3", "-o", str(tmp / "probe"),
                    str(tmp / "probe.cu")], check=True)
    run = subprocess.run([str(tmp / "probe")], capture_output=True, text=True)
    if run.returncode:
        print(f"mma_overlap: the probe failed: {run.stderr}", file=sys.stderr)
        return 1
    rows = [json.loads(line) for line in run.stdout.splitlines()]
    print(f"[device] {smi}")
    for r in rows:
        print(f"  mma alone {r['mma_ms']:.4f} ms ({r['mma_tops']:.0f} TOPS); with "
              f"{r['alu_iters']} rounds of the other warps' work: half2 {r['half2_ms']:.4f} "
              f"alone, {r['half2_with_mma_ms']:.4f} beside the MMAs; integer {r['int_ms']:.4f} "
              f"/ {r['int_with_mma_ms']:.4f}; f32 {r['f32_ms']:.4f} / "
              f"{r['f32_with_mma_ms']:.4f}", flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"device": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
