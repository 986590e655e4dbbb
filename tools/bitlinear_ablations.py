#!/usr/bin/env python3
"""Ablations of the bitlinear kernel on BitNet-1.58B's stage runs, on one
CUDA card.

    python3 tools/bitlinear_ablations.py

Builds variants of ``src/repro_torch/csrc/bitlinear.cu``, each one text
substitution of the source (some compute wrong results on purpose: they
time what is left), into ``build/ablations/`` with the package's nvcc
flags, and times each variant's grouped launch on the same stage runs as
``chip_smoke.py``'s grouped rows (``chip_smoke.stage_group``; weights cold,
rotated through copies larger than L2): device µs per launch from
torch.profiler, and a single decode slice's host time a call.  Also times
a plain 16-byte-load kernel that reads the same weight tiles (the stage's
bytes without the kernel), and writes each block's start, end and SM for
the base variant (``%globaltimer``).  Prints one JSON line per
measurement, then the card's name and power limit.  Imports nothing of
JAX.
"""
import ctypes
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

OUT = os.path.join(ROOT, "build", "ablations")

PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// reads rows x 128-byte column strips of a [rows, ldb] byte matrix with
// 16-byte loads, 64 rows a block, and keeps nothing
__global__ void probe_kernel(const uint8_t* __restrict__ w, long long ldb,
                             int rows, int* out) {
  const int c = blockIdx.x * 128 + (threadIdx.x & 7) * 16;
  uint32_t acc = 0;
#pragma unroll 4
  for (int r = blockIdx.y * 64 + (threadIdx.x >> 3);
       r < min(blockIdx.y * 64 + 64, rows); r += 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(w + r * ldb + c);
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == 0x12345678u) out[0] = 1;
}
extern "C" int probe_launch(const void* w, long long ldb, int rows,
                            int cols, void* out, void* stream) {
  const dim3 grid(cols / 128, (rows + 63) / 64);
  probe_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)w, ldb, rows, (int*)out);
  return (int)cudaGetLastError();
}
"""

TIMELINE_HEAD = """__device__ unsigned long long g_times[3 * 8192];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
"""
TIMELINE_TAIL = """
extern "C" int dump_times(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_times, sizeof(g_times));
}
"""


def variants(src: str):
    """name -> source: the base and one substitution each."""
    def sub(text, old, new):
        if old not in text:
            raise SystemExit(f"ablation anchor not found: {old[:60]!r}")
        return text.replace(old, new)

    mma = ("          mma_u8s8(acc[i][0], lo4[0], lo4[1], hi4[0], hi4[1], "
           "b0, b1);\n          mma_u8s8(acc[i][1], lo4[2], lo4[3], hi4[2], "
           "hi4[3], b0, b1);\n          mma_u8s8(xsum[i], ones, ones, ones, "
           "ones, b0, b1);")
    no_mma = ("          acc[i][0][0] += lo4[0] ^ lo4[1] ^ hi4[0] ^ hi4[1] "
              "^ b0;\n          acc[i][1][0] += lo4[2] ^ lo4[3] ^ hi4[2] ^ "
              "hi4[3] ^ b1;\n          (void)ones;")
    unpack = "      planes_2bit(word(W, kk * 8 + q), r);"
    raw = "      r[0] = r[1] = r[2] = r[3] = word(W, kk * 8 + q);"
    red = "          atomicAdd(dst, value);"
    out = {"base": src,
           "no_unpack": sub(src, unpack, raw),
           "no_mma": sub(src, mma, no_mma),
           "loads_only": sub(sub(sub(src, unpack, raw), mma, no_mma), red,
                             "          *dst = value;"),
           "split_target_8": sub(src, "target = 2LL *", "target = 8LL *"),
           "ring_8": sub(src, "  constexpr int BM = 8 * MT;\n",
                         "  constexpr int BM = 8 * MT;\n"
                         "  constexpr int STAGES = BITS == 2 ? 8 : 4;\n"),
           "one_capacity": sub(src, "SMALL = 8, LARGE = 400",
                               "SMALL = 0, LARGE = 400")}
    timed = sub(src, "namespace {\n\nusing namespace i8mma;",
                TIMELINE_HEAD + "namespace {\n\nusing namespace i8mma;")
    timed = sub(timed, "  // the item whose tiles hold this block\n",
                "  const unsigned long long t_start = now_ns();\n"
                "  // the item whose tiles hold this block\n")
    timed = sub(timed, "  int32_t* C = it.c;\n", """  if (threadIdx.x == 0 && blockIdx.x < 8192) {
    unsigned sm;
    asm volatile("mov.u32 %0, %smid;" : "=r"(sm));
    g_times[3 * blockIdx.x] = t_start;
    g_times[3 * blockIdx.x + 1] = now_ns();
    g_times[3 * blockIdx.x + 2] = sm;
  }
  int32_t* C = it.c;
""")
    out["timeline"] = timed + TIMELINE_TAIL
    return out


def build_all(sources):
    from repro_torch.kernels import build

    os.makedirs(OUT, exist_ok=True)
    shutil.copy(os.path.join(build.CSRC, "int8_mma.cuh"), OUT)
    jobs = {}
    for name, text in sources.items():
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        jobs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             os.path.join(OUT, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
    return libs


def use(ops, lib):
    fn = lib.bitlinear_grouped_launch
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ops._entry = fn


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.bitlinear import ops

    if not torch.cuda.is_available():
        print("bitlinear_ablations: needs a CUDA card", file=sys.stderr)
        return 2
    with open(os.path.join(ROOT, "src", "repro_torch", "csrc",
                           "bitlinear.cu")) as f:
        sources = variants(f.read())
    sources["probe"] = PROBE
    libs = build_all(sources)
    stages = [wl for m in (1, 24) for wl in cs.serve_workloads(m)]
    groups = []
    for i, wl in enumerate(stages):
        wbytes = wl.count * wl.k * wl.n * wl.weight_bits // 8
        copies = min(max(cs.L2_FLUSH_BYTES // wbytes, 1), 32)
        groups.append((wl,) + cs.stage_group(wl, i, copies))
    x1, w1, o1 = (torch.ones((1, 2560), dtype=torch.int8, device="cuda"),
                  torch.ones((640, 864), dtype=torch.uint8, device="cuda"),
                  torch.zeros((1, 864), dtype=torch.int32, device="cuda"))
    for name, lib in libs.items():
        if name in ("probe", "timeline"):
            continue
        use(ops, lib)
        # one decode mlp_up slice, a group of one: host time a call
        one = lambda: ops.tile_gemm(x1, w1, bits=2, out=o1)   # noqa: E731
        one()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            one()
        host_us = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
        cs.emit({"variant": name, "stage": "mlp_up slice", "m": 1,
                 "host_us": host_us,
                 "device_us": cs.device_us(lambda j: one(), 30,
                                           "bitlinear_kernel")})
        for wl, x, packed, acc, slices, nbytes in groups:
            call = lambda j: ops.grouped_tile_gemm(     # noqa: E731
                x, packed[j % len(packed)], acc, slices, bits=2)
            cs.emit({"variant": name, "stage": wl.stage, "m": wl.m,
                     "items": len(slices), "bytes": nbytes,
                     "device_us": cs.device_us(call, 30, "bitlinear_kernel"),
                     "bound_us": nbytes / cs.HBM_BYTES_PER_S * 1e6})
    probe = libs["probe"].probe_launch
    probe.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    for wl, x, packed, acc, slices, nbytes in groups[:4]:
        count, rows, cols = packed[0].shape

        def read(j, packed=packed, count=count, rows=rows, cols=cols):
            flat = packed[j % len(packed)]
            probe(flat.data_ptr(), cols, rows * count, cols - cols % 128,
                  sink.data_ptr(), torch.cuda.current_stream().cuda_stream)
        cs.emit({"variant": "probe_loads", "stage": wl.stage, "m": wl.m,
                 "bytes": packed[0].numel(),
                 "device_us": cs.device_us(read, 30, "probe_kernel")})
    use(ops, libs["timeline"])
    dump = libs["timeline"].dump_times
    dump.argtypes = [ctypes.c_void_p]
    for wl, x, packed, acc, slices, nbytes in (groups[2], groups[6]):
        buf = np.zeros(3 * 8192, dtype=np.uint64)
        for j in range(4):
            ops.grouped_tile_gemm(x, packed[j % len(packed)], acc, slices,
                                  bits=2)
        torch.cuda.synchronize()
        dump(buf.ctypes.data)
        t = buf.reshape(-1, 3)[:, :]
        t = t[t[:, 1] >= t[:, 0]]
        t = t[t[:, 0] >= t[:, 0].max() - 10**6]     # the last launch only
        start = (t[:, 0] - t[:, 0].min()) / 1e3
        dur = (t[:, 1] - t[:, 0]) / 1e3
        cs.emit({"variant": "timeline", "stage": wl.stage, "m": wl.m,
                 "blocks": int(len(t)),
                 "sms": int(len(set(t[:, 2].tolist()))),
                 "blocks_per_sm_max": int(np.bincount(
                     t[:, 2].astype(int)).max()),
                 "start_us_max": float(start.max()),
                 "block_us": [float(np.percentile(dur, p))
                              for p in (10, 50, 90, 100)]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
