// ssd.cuh: what the SSD scan's forward (ssd.cu) and backward (ssd_bwd.cu)
// share: the tile limits, the operands' strides, cp.async staging into
// shared memory, the in-chunk cumulative sum of the log decays, and the
// body of the forward's per-chunk outer-product kernel, which computes the
// chunk state s_c = (B * exp(la_q - la))^T dtx (the backward's readout
// gradient has a tensor-core kernel of its own in ssd_bwd.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ssd {

constexpr int THREADS = 256;   // 16 x 16
constexpr int QMAX = 128;      // rows i = ty + 16 r, r < 8
constexpr int PMAX = 64;       // columns p = tx + 16 c, c < 4
constexpr int NMAX = 128;      // state rows n = ty + 16 r, r < 8

struct Strides {
  long long b, h, s;           // elements between batches, heads, steps
};

inline bool shape_ok(int q, int n, int p) {
  return q >= 1 && q <= QMAX && n >= 1 && n <= NMAX && p >= 1 && p <= PMAX;
}

inline int round4(int x) { return (x + 3) & ~3; }

// Shared memory of chunk_outer: a [q][round4(N)], v [q][round4(P)], la and
// the weights [q], and 64 floats of slack that the 4-wide reads past a row
// end may touch.
inline long long state_smem_bytes(int q, int n, int p) {
  return (static_cast<long long>(q) * (round4(n) + round4(p)) + 2 * q + 64) *
         sizeof(float);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Copies a [rows][cols] tile whose rows lie `sstride` floats apart into
// shared memory rows `dpitch` floats apart, with cp.async: 16-byte copies
// when `vec` (cols, dpitch and sstride multiples of 4, both bases 16-byte
// aligned), else 4-byte ones.  The row and column of each thread's next
// element advance by constants, with no division in the loop.
__device__ __forceinline__ void stage(float* dst, int dpitch, const float* src,
                                      long long sstride, int rows, int cols,
                                      bool vec) {
  const int w = vec ? 4 : 1, cw = cols / w;
  const int dr = THREADS / cw, dc = THREADS % cw;
  int r = threadIdx.x / cw, c = threadIdx.x % cw;
  while (r < rows) {
    if (vec)
      cp_async16(dst + r * dpitch + 4 * c, src + r * sstride + 4 * c);
    else
      cp_async4(dst + r * dpitch + c, src + r * sstride + c);
    r += dr;
    c += dc;
    if (c >= cw) {
      c -= cw;
      ++r;
    }
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// la[t] = dta[0] + ... + dta[t] for t < q (one warp; lanes 0..31)
__device__ __forceinline__ void chunk_cumsum(const float* dta, long long ss,
                                             int q, float* la, int lane) {
  float v[QMAX / 32];
  float run = 0.0f;
#pragma unroll
  for (int k = 0; k < QMAX / 32; ++k) {
    const int t = lane * (QMAX / 32) + k;
    run += t < q ? dta[t * ss] : 0.0f;
    v[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const float excl = incl - run;
#pragma unroll
  for (int k = 0; k < QMAX / 32; ++k) {
    const int t = lane * (QMAX / 32) + k;
    if (t < q) la[t] = v[k] + excl;
  }
}

// The body of a kernel over the grid (chunks, heads, batch): out[b, h, c]
// [N, P] = sum over the chunk's steps j of w_j a_j v_j^T, with
// w_j = exp(la_q - la_j) (the forward's s_c: a = B, v = dtx; its total log
// decay la_q goes to decay[b, h, c] when decay is not null).
// Thread (ty, tx) holds out[n][p] for p = 4 tx + k and n = 4 ty + 64 g + k'
// (k, k' < 4, g < 2), reading a and v rows four floats at a time.
__device__ __forceinline__ void chunk_outer(
    const float* __restrict__ dta, Strides sa, const float* __restrict__ v,
    Strides sv, const float* __restrict__ a, Strides sm,
    float* __restrict__ out, float* __restrict__ decay, int heads, int S,
    int P, int N, int Q, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int np = (N + 3) & ~3, pp = (P + 3) & ~3;
  float* bs = smem;            // a [q][np]
  float* ds = bs + Q * np;     // v [q][pp]
  float* la = ds + Q * pp;     // [q]
  float* ws = la + Q;          // [q] the weights w_j

  const int c = blockIdx.x, nc = gridDim.x;
  const long long hi = blockIdx.y, bi = blockIdx.z;
  const int s0 = c * Q, q = min(Q, S - s0);
  dta += bi * sa.b + hi * sa.h + s0 * sa.s;
  v += bi * sv.b + hi * sv.h + s0 * sv.s;
  a += bi * sm.b + hi * sm.h + s0 * sm.s;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  stage(bs, np, a, sm.s, q, N, vec);
  stage(ds, pp, v, sv.s, q, P, vec);
  if (tid < 32) chunk_cumsum(dta, sa.s, q, la, tid);
  cp_async_wait_all();
  __syncthreads();
  const float la_last = la[q - 1];
  if (tid < q) ws[tid] = expf(la_last - la[tid]);
  __syncthreads();

  const int groups = (N + 63) / 64;
  float st[2][4][4];
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) st[g][r][k] = 0.0f;
  for (int j = 0; j < q; ++j) {
    const float w = ws[j];
    float4 dv = *reinterpret_cast<const float4*>(ds + j * pp + 4 * tx);
    dv.x *= w;
    dv.y *= w;
    dv.z *= w;
    dv.w *= w;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      if (g < groups) {
        const float4 bv =
            *reinterpret_cast<const float4*>(bs + j * np + 64 * g + 4 * ty);
        const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          st[g][r][0] = fmaf(b4[r], dv.x, st[g][r][0]);
          st[g][r][1] = fmaf(b4[r], dv.y, st[g][r][1]);
          st[g][r][2] = fmaf(b4[r], dv.z, st[g][r][2]);
          st[g][r][3] = fmaf(b4[r], dv.w, st[g][r][3]);
        }
      }
    }
  }
  const long long slot = (bi * heads + hi) * nc + c;
  float* dst = out + slot * N * P;
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = 64 * g + 4 * ty + r;
      if (g >= groups || n >= N) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = 4 * tx + k;
        if (p < P) dst[n * P + p] = st[g][r][k];
      }
    }
  if (decay != nullptr && tid == 0) decay[slot] = la_last;
}

// 16-byte staging copies where the rows of v, a (and more) allow them
inline bool aligned16(const void* ptr, long long s0, long long s1,
                      long long s2) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s0 % 4 == 0 &&
         s1 % 4 == 0 && s2 % 4 == 0;
}

}  // namespace ssd
