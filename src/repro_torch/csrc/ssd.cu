// ssd: the Mamba-2 chunked SSD scan (state-space duality), float32.
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_scan` of
// src/repro/kernels/ssd/kernel.py.  Inputs are pre-scaled (dta = dt * A,
// negative; dtx = dt * x).  Per chunk c of q steps, with la = cumsum(dta):
//
//     y_c  = ((C B^T) o L) dtx  +  (C * exp(la)) h_{c-1}
//     L_ij = exp(la_i - la_j) for i >= j, else 0
//     h_c  = exp(la_q) h_{c-1}  +  s_c,   s_c = (B * exp(la_q - la))^T dtx
//
// The Pallas kernel walks a grid (bh, chunk) whose chunk axis runs in order
// and carries h [N, P] in VMEM scratch.  On the H100 that order would leave
// one block per head (112 blocks for 132 SMs at Zamba2-7B, 24 at
// Mamba2-130m), so the scan is split the way `ssd_chunked_ref`
// (kernels/ssd/ref.py) computes it, into three kernels on one stream:
//
//   1. ssd_kernel_state, grid (chunks, heads, batch): each chunk's own
//      state s_c [N, P] and its total log decay la_q, into float32 scratch
//      [B, H, nc, N, P] and [B, H, nc] that the wrapper allocates;
//   2. ssd_kernel_pass, grid (batch * heads, N * P / 256): one thread per
//      state element runs h <- exp(la_q) h + s_c over the chunks in order,
//      overwrites each slot with the state that enters its chunk, and
//      writes the terminal state when asked (prefill hands it to decode);
//   3. ssd_kernel_scan, grid (chunks, heads, batch): y of one chunk from
//      its C, B, dtx and entering state, computing only the lower triangle
//      of the score tile: with rows i = ty + 16 r and columns j = tx + 16 c
//      of a 16 x 16 thread grid, every (r, c) with c > r is wholly above the
//      diagonal and is skipped (36 of 64 register tiles remain).  B, C, dtx
//      and h are staged with cp.async; the score tile overwrites C and B
//      once both are read, so at N = 64 a block needs 100 KB and two blocks
//      share an SM.  y is written through strides ([B, S, H, P] order).
//
// Any chunk length q <= 128 (a short prompt is one short chunk), and S need
// not be a multiple of it: the last chunk is simply shorter, which equals
// padding with dta = 0 and zero inputs.  Head width P <= 64, state width
// N <= 128.  Every operand is read through (batch, head, step) strides with
// unit stride along its last axis, so the group-shared B and C of Mamba-2
// come in as one [batch, seq, N] tensor with head stride 0, uncopied.
//
// What bounds it on an H100: at Zamba2-7B's prefill (112 heads, N = P = 64,
// S = 4096, q = 128) the work needed is ~11 GFLOP of float32 multiply-adds
// (the causal half of each chunk's score tile C B^T, once per batch since
// the heads share B and C, and per head its product with dtx, the state
// readout and the chunk states) against ~240 MB of dtx, y and the shared
// B, C, so the float32 CUDA-core rate (67 TFLOP/s) bounds it at ~0.17 ms;
// the bytes take ~0.07 ms and the state scratch (59 MB, written, read,
// rewritten and read again) ~0.07 ms more.  The scan here computes the
// score tile per head (~15 GFLOP in all); sharing it is open work.  The arithmetic stays float32 FMA: TF32 tensor
// cores keep ~3 digits, and the kernel is held to 1e-4 (3xTF32 on mma.sync
// is the next step).
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd.cuh"

namespace {

using ssd::NMAX;
using ssd::PMAX;
using ssd::QMAX;
using ssd::Strides;
using ssd::THREADS;
using ssd::chunk_cumsum;
using ssd::cp_async_wait_all;
using ssd::stage;

// The scan kernel lays its tiles out for QMAX rows whatever the chunk (its
// register tiles cover rows 0..127 and read rows past the chunk, masked).
// Floats of its region that holds C and then B (pitch N + 1), and
// afterwards the score tile (pitch QMAX + 1); h_in sits where B goes.
__host__ __device__ inline int scan_xy_floats(int n, int p) {
  const int pn = n + 1;
  int xy = 2 * QMAX * pn;
  if (QMAX * pn + n * p > xy) xy = QMAX * pn + n * p;
  if (QMAX * (QMAX + 1) > xy) xy = QMAX * (QMAX + 1);
  return xy;
}

long long scan_smem_bytes(int n, int p) {
  return (scan_xy_floats(n, p) + QMAX * p + QMAX) * sizeof(float);
}

// 1. s_c = (B * exp(la_q - la))^T dtx  ->  states[b, h, c]; la_q -> decay
__global__ void __launch_bounds__(THREADS, 2)
ssd_kernel_state(const float* __restrict__ dta, Strides sa,
                 const float* __restrict__ dtx, Strides sx,
                 const float* __restrict__ Bm, Strides sb,
                 float* __restrict__ states, float* __restrict__ decay,
                 int heads, int S, int P, int N, int Q, int vec) {
  ssd::chunk_outer(dta, sa, dtx, sx, Bm, sb, states, decay, heads, S, P, N,
                   Q, vec);
}

// 2. over the chunks in order: slot c <- h entering chunk c;
//    h <- exp(la_q) h + s_c; the terminal h -> hfin when asked
__global__ void __launch_bounds__(THREADS)
ssd_kernel_pass(float* __restrict__ states, const float* __restrict__ decay,
                float* __restrict__ hfin, int nc, int NP) {
  const int e = blockIdx.y * THREADS + threadIdx.x;
  if (e >= NP) return;
  const long long bh = blockIdx.x;
  float* st = states + bh * nc * NP + e;
  const float* dec = decay + bh * nc;
  constexpr int AHEAD = 8;     // loads issued before the dependent updates
  float h = 0.0f;
  for (int c0 = 0; c0 < nc; c0 += AHEAD) {
    float s[AHEAD], a[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      if (c0 + k < nc) {
        s[k] = st[static_cast<long long>(c0 + k) * NP];
        a[k] = expf(dec[c0 + k]);
      }
    }
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      if (c0 + k < nc) {
        st[static_cast<long long>(c0 + k) * NP] = h;
        h = fmaf(a[k], h, s[k]);
      }
    }
  }
  if (hfin != nullptr) hfin[bh * NP + e] = h;
}

// 3. y_c = ((C B^T) o L) dtx + (C * exp(la)) h_in, lower triangle only
__global__ void __launch_bounds__(THREADS, 2)
ssd_kernel_scan(const float* __restrict__ dta, Strides sa,
                const float* __restrict__ dtx, Strides sx,
                const float* __restrict__ Bm, Strides sb,
                const float* __restrict__ Cm, Strides sc,
                float* __restrict__ y, Strides sy,
                const float* __restrict__ states, int heads, int S, int P,
                int N, int Q, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int pn = N + 1;        // pitch of B and C rows (odd: no bank conflicts)
  const int pq = QMAX + 1;     // pitch of score rows
  float* xs = smem;            // C [128][pn]; then the score tile G [128][pq]
  float* ys = xs + QMAX * pn;  // h_in [N][P], then B [128][pn]
  float* ds = smem + scan_xy_floats(N, P);   // dtx [128][P]
  float* la = ds + QMAX * P;   // [128]

  const int c = blockIdx.x, nc = gridDim.x;
  const long long hi = blockIdx.y, bi = blockIdx.z;
  const int s0 = c * Q, q = min(Q, S - s0);
  dta += bi * sa.b + hi * sa.h + s0 * sa.s;
  dtx += bi * sx.b + hi * sx.h + s0 * sx.s;
  Bm += bi * sb.b + hi * sb.h + s0 * sb.s;
  Cm += bi * sc.b + hi * sc.h + s0 * sc.s;
  y += bi * sy.b + hi * sy.h + s0 * sy.s;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bool carry = c > 0;    // chunk 0 enters with h = 0

  stage(xs, pn, Cm, sc.s, q, N, false);
  stage(ds, P, dtx, sx.s, q, P, vec);
  if (carry)
    stage(ys, P, states + ((bi * heads + hi) * nc + c) * N * P, P, N, P,
          vec);
  if (tid < 32) chunk_cumsum(dta, sa.s, q, la, tid);
  cp_async_wait_all();
  __syncthreads();

  float lai[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty + 16 * r;
    lai[r] = i < q ? la[i] : 0.0f;
  }

  // inter-chunk part: acc = (C * exp(la)) h_in
  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.0f;
  if (carry) {
    for (int n = 0; n < N; ++n) {
      float hv[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int p = tx + 16 * cc;
        hv[cc] = p < P ? ys[n * P + p] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float cv = xs[(ty + 16 * r) * pn + n];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[r][cc] = fmaf(cv, hv[cc], acc[r][cc]);
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float e = expf(lai[r]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[r][cc] *= e;
    }
    __syncthreads();           // h_in is read: B takes its place
  }
  stage(ys, pn, Bm, sb.s, q, N, false);
  cp_async_wait_all();
  __syncthreads();

  // score tile G = C B^T on the register tiles (r, c <= r); rows i >= q and
  // columns j >= q read stale values that are masked below (the tiles span
  // 128 rows whatever the chunk)
  float g[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int cc = 0; cc <= r; ++cc) g[r][cc] = 0.0f;
  for (int n = 0; n < N; ++n) {
    float bv[8], cv[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      bv[k] = ys[(tx + 16 * k) * pn + n];
      cv[k] = xs[(ty + 16 * k) * pn + n];
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int cc = 0; cc <= r; ++cc) g[r][cc] = fmaf(cv[r], bv[cc], g[r][cc]);
  }
  __syncthreads();             // C and B are read: G takes their place
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int cc = 0; cc <= r; ++cc) {
      const int j = tx + 16 * cc;
      const bool live = j <= i && i < q;
      xs[i * pq + j] = live ? g[r][cc] * expf(lai[r] - la[j]) : 0.0f;
    }
  }
  __syncthreads();

  // intra-chunk part: acc += G dtx over j <= i; row tile r reads columns
  // j < 16 (r + 1), and G is 0 above the diagonal within tile r == j / 16
  for (int jb = 0; jb * 16 < q; ++jb) {
    const int jn = min(16, q - jb * 16);
    for (int jj = 0; jj < jn; ++jj) {
      const int j = jb * 16 + jj;
      float dv[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int p = tx + 16 * cc;
        dv[cc] = p < P ? ds[j * P + p] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r >= jb) {
          const float gv = xs[(ty + 16 * r) * pq + j];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            acc[r][cc] = fmaf(gv, dv[cc], acc[r][cc]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty + 16 * r;
    if (i >= q) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int p = tx + 16 * cc;
      if (p < P) y[i * sy.s + p] = acc[r][cc];
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// Every tensor is float32 and indexed [batch, head, step(, last)]: the three
// strides of each (in elements) are passed, the last axis has unit stride.
// dta [B, H, S], dtx [B, H, S, P], Bm / Cm [B, H, S, N], y [B, H, S, P];
// hfin, if not null, is a contiguous [B * H, N, P] output of the terminal
// state.  states [B * H * nc * N * P] and decay [B * H * nc] are float32
// scratch (nc = ceil(S / chunk)).
extern "C" int ssd_launch(const void* dta, long long sa_b, long long sa_h,
                          long long sa_s, const void* dtx, long long sx_b,
                          long long sx_h, long long sx_s, const void* Bm,
                          long long sb_b, long long sb_h, long long sb_s,
                          const void* Cm, long long sc_b, long long sc_h,
                          long long sc_s, void* y, long long sy_b,
                          long long sy_h, long long sy_s, void* hfin,
                          void* states, void* decay, int batch, int heads,
                          int S, int P, int N, int chunk, void* stream) {
  if (batch < 1 || heads < 1 || S < 1 || batch > 65535 || heads > 65535 ||
      !ssd::shape_ok(chunk, N, P))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (S + chunk - 1) / chunk;
  if (states == nullptr || decay == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in = false;   // the largest shared memory, once
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel_state, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(ssd::state_smem_bytes(QMAX, NMAX, PMAX)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          ssd_kernel_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(scan_smem_bytes(NMAX, PMAX)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte staging copies where dtx, B and C rows allow them
  const auto al = ssd::aligned16;
  const int vec = N % 4 == 0 && P % 4 == 0 && al(dtx, sx_b, sx_h, sx_s) &&
                  al(Bm, sb_b, sb_h, sb_s) && al(Cm, sc_b, sc_h, sc_s);
  const Strides a{sa_b, sa_h, sa_s}, x{sx_b, sx_h, sx_s}, b{sb_b, sb_h, sb_s},
      c{sc_b, sc_h, sc_s}, o{sy_b, sy_h, sy_s};
  const dim3 grid(nc, heads, batch);
  float* sp = static_cast<float*>(states);
  float* dp = static_cast<float*>(decay);
  ssd_kernel_state<<<grid, THREADS, ssd::state_smem_bytes(chunk, N, P),
                     st>>>(
      static_cast<const float*>(dta), a, static_cast<const float*>(dtx), x,
      static_cast<const float*>(Bm), b, sp, dp, heads, S, P, N, chunk, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 pgrid(batch * heads, (N * P + THREADS - 1) / THREADS);
  ssd_kernel_pass<<<pgrid, THREADS, 0, st>>>(
      sp, dp, static_cast<float*>(hfin), nc, N * P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bytes = static_cast<int>(scan_smem_bytes(N, P));
  ssd_kernel_scan<<<grid, THREADS, bytes, st>>>(
      static_cast<const float*>(dta), a, static_cast<const float*>(dtx), x,
      static_cast<const float*>(Bm), b, static_cast<const float*>(Cm), c,
      static_cast<float*>(y), o, sp, heads, S, P, N, chunk, vec);
  return static_cast<int>(cudaGetLastError());
}
