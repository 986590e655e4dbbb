// ssd: the Mamba-2 chunked SSD scan (state-space duality), float32.
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_scan` of
// src/repro/kernels/ssd/kernel.py.  Inputs are pre-scaled (dta = dt * A,
// negative; dtx = dt * x).  Per chunk of q steps, with la = cumsum(dta):
//
//     y_c  = ((C B^T) o L) dtx  +  (C * exp(la)) h_{c-1}
//     L_ij = exp(la_i - la_j) for i >= j, else 0
//     h_c  = exp(la_q) h_{c-1}  +  (B * exp(la_q - la))^T dtx
//
// The Pallas kernel walks a grid (bh, chunk) whose chunk axis runs in order
// and carries the state h [N, P] in VMEM scratch.  Here blocks run in
// parallel and in no order, so one block per (batch, head) runs the chunk
// loop itself and keeps h in shared memory for the whole sequence; each
// chunk's B, C and dtx are staged through shared memory, and the masked
// score tile C B^T o L takes C's place once C has been read.  The block also
// writes the terminal state h when asked (prefill hands it to decode), which
// the Pallas kernel leaves to the chunked reference.
//
// Any chunk length q <= 128 (a short prompt is one short chunk), and S need
// not be a multiple of it: the last chunk is simply shorter, which equals
// padding with dta = 0 and zero inputs.  Head width P <= 64, state width
// N <= 128.  Every operand is read through (batch, head, step) strides with
// unit stride along its last axis, so the group-shared B and C of Mamba-2
// come in as one [batch, seq, N] tensor with head stride 0, uncopied.
//
// What bounds it on an H100: at Zamba2-7B's prefill (112 heads, N = P = 64,
// S = 4096, q = 128) the work is ~15 GFLOP of float32 multiply-adds (the
// causal half of each score tile) against ~240 MB of dtx, y and the shared
// B, C, so the float32 CUDA-core rate (67 TFLOP/s) bounds it at ~0.23 ms;
// the bytes take ~0.07 ms.  This first version multiplies on the CUDA cores
// from shared memory with a 16 x 16 thread grid holding register tiles,
// computes the full score tile (the masked half too), and has only one block
// per head: 112 blocks for 132 SMs, 24 for Mamba2-130m.  Splitting heads
// over more blocks, skipping the masked half, and tensor cores (tf32 /
// wgmma) are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // 16 x 16
constexpr int QMAX = 128;      // rows i = ty + 16 r, r < 8
constexpr int PMAX = 64;       // columns p = tx + 16 c, c < 4
constexpr int NMAX = 128;      // state rows n = ty + 16 r, r < 8

struct Strides {
  long long b, h, s;           // elements between batches, heads, steps
};

// Shared memory (bytes) one block needs at chunk length q, state width n and
// head width p; 0 if the shape is outside what the kernel takes.
long long smem_bytes(int q, int n, int p) {
  if (q < 1 || q > QMAX || n < 1 || n > NMAX || p < 1 || p > PMAX) return 0;
  const long long pn = n + 1, pq = q + 1;
  const long long xs = q * pn > q * pq ? q * pn : q * pq;
  return (xs + q * pn + q * p + n * p + 2 * q) * sizeof(float);
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_kernel(const float* __restrict__ dta, Strides sa,
           const float* __restrict__ dtx, Strides sx,
           const float* __restrict__ Bm, Strides sb,
           const float* __restrict__ Cm, Strides sc,
           float* __restrict__ y, Strides sy,
           float* __restrict__ hfin, int heads, int S, int P, int N, int Q) {
  extern __shared__ float smem[];
  const int pn = N + 1;        // pitch of B and C rows (odd: no bank conflicts)
  const int pq = Q + 1;        // pitch of score rows
  float* xs = smem;            // C [q][pn], then the score tile G [q][pq]
  float* bs = xs + (Q * pn > Q * pq ? Q * pn : Q * pq);   // B [q][pn]
  float* ds = bs + Q * pn;     // dtx [q][P]
  float* hs = ds + Q * P;      // state h [N][P]
  float* la = hs + N * P;      // [q] cumulative log decay within the chunk
  float* wo = la + Q;          // [q] exp(la_last - la_j)

  const int bh = blockIdx.x;
  const long long bi = bh / heads, hi = bh % heads;
  dta += bi * sa.b + hi * sa.h;
  dtx += bi * sx.b + hi * sx.h;
  Bm += bi * sb.b + hi * sb.h;
  Cm += bi * sc.b + hi * sc.h;
  y += bi * sy.b + hi * sy.h;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  for (int i = tid; i < N * P; i += THREADS) hs[i] = 0.0f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    const int q = min(Q, S - s0);
    for (int i = tid; i < q * N; i += THREADS) {
      const int r = i / N, c = i % N;
      xs[r * pn + c] = Cm[(s0 + r) * sc.s + c];
      bs[r * pn + c] = Bm[(s0 + r) * sb.s + c];
    }
    for (int i = tid; i < q * P; i += THREADS) {
      const int r = i / P, c = i % P;
      ds[r * P + c] = dtx[(s0 + r) * sx.s + c];
    }
    if (tid < 32) {            // la = inclusive cumsum of dta (one warp)
      float v[QMAX / 32];
      float run = 0.0f;
#pragma unroll
      for (int k = 0; k < QMAX / 32; ++k) {
        const int t = tid * (QMAX / 32) + k;
        run += t < q ? dta[(s0 + t) * sa.s] : 0.0f;
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float excl = incl - run;
#pragma unroll
      for (int k = 0; k < QMAX / 32; ++k) {
        const int t = tid * (QMAX / 32) + k;
        if (t < q) la[t] = v[k] + excl;
      }
    }
    __syncthreads();
    const float la_last = la[q - 1];
    if (tid < q) wo[tid] = expf(la_last - la[tid]);

    // inter-chunk part: acc = (C * exp(la)) h_{c-1}
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
    for (int n = 0; n < N; ++n) {
      float hv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = tx + 16 * c;
        hv[c] = p < P ? hs[n * P + p] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = ty + 16 * r;
        if (i < q) {
          const float cv = xs[i * pn + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cv, hv[c], acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      const float e = i < q ? expf(la[i]) : 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= e;
    }

    // score tile G = C B^T, masked and decayed, written over C
    float g[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) g[r][c] = 0.0f;
    for (int n = 0; n < N; ++n) {
      float bv[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = tx + 16 * c;
        bv[c] = j < q ? bs[j * pn + n] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = ty + 16 * r;
        if (i < q) {
          const float cv = xs[i * pn + n];
#pragma unroll
          for (int c = 0; c < 8; ++c) g[r][c] = fmaf(cv, bv[c], g[r][c]);
        }
      }
    }
    __syncthreads();           // every thread is done reading C
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      if (i >= q) continue;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = tx + 16 * c;
        if (j < q)
          xs[i * pq + j] = j <= i ? g[r][c] * expf(la[i] - la[j]) : 0.0f;
      }
    }
    __syncthreads();

    // intra-chunk part: acc += G dtx; then write y
    for (int j = 0; j < q; ++j) {
      float dv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = tx + 16 * c;
        dv[c] = p < P ? ds[j * P + p] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = ty + 16 * r;
        if (i < q) {
          const float gv = xs[i * pq + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(gv, dv[c], acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      if (i >= q) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = tx + 16 * c;
        if (p < P) y[(s0 + i) * sy.s + p] = acc[r][c];
      }
    }

    // state carry: h = exp(la_last) h + (B * wo)^T dtx, each thread its own
    // h elements (rows n = ty + 16 r, columns p = tx + 16 c)
    float hn[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) hn[r][c] = 0.0f;
    for (int j = 0; j < q; ++j) {
      const float w = wo[j];
      float dv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = tx + 16 * c;
        dv[c] = p < P ? ds[j * P + p] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int n = ty + 16 * r;
        if (n < N) {
          const float bv = bs[j * pn + n] * w;
#pragma unroll
          for (int c = 0; c < 4; ++c) hn[r][c] = fmaf(bv, dv[c], hn[r][c]);
        }
      }
    }
    const float decay = expf(la_last);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int n = ty + 16 * r;
      if (n >= N) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = tx + 16 * c;
        if (p < P) hs[n * P + p] = decay * hs[n * P + p] + hn[r][c];
      }
    }
    __syncthreads();           // before the next chunk restages B, C, dtx
  }

  if (hfin != nullptr) {
    float* dst = hfin + static_cast<long long>(bh) * N * P;
    for (int i = tid; i < N * P; i += THREADS) dst[i] = hs[i];
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// Every tensor is float32 and indexed [batch, head, step(, last)]: the three
// strides of each (in elements) are passed, the last axis has unit stride.
// dta [B, H, S], dtx [B, H, S, P], Bm / Cm [B, H, S, N], y [B, H, S, P];
// hfin, if not null, is a contiguous [B * H, N, P] output of the terminal
// state.
extern "C" int ssd_launch(const void* dta, long long sa_b, long long sa_h,
                          long long sa_s, const void* dtx, long long sx_b,
                          long long sx_h, long long sx_s, const void* Bm,
                          long long sb_b, long long sb_h, long long sb_s,
                          const void* Cm, long long sc_b, long long sc_h,
                          long long sc_s, void* y, long long sy_b,
                          long long sy_h, long long sy_s, void* hfin,
                          int batch, int heads, int S, int P, int N,
                          int chunk, void* stream) {
  const long long bytes = smem_bytes(chunk, N, P);
  if (batch < 1 || heads < 1 || S < 1 || bytes == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_kernel<<<batch * heads, THREADS, bytes,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dta), Strides{sa_b, sa_h, sa_s},
      static_cast<const float*>(dtx), Strides{sx_b, sx_h, sx_s},
      static_cast<const float*>(Bm), Strides{sb_b, sb_h, sb_s},
      static_cast<const float*>(Cm), Strides{sc_b, sc_h, sc_s},
      static_cast<float*>(y), Strides{sy_b, sy_h, sy_s},
      static_cast<float*>(hfin), heads, S, P, N, chunk);
  return static_cast<int>(cudaGetLastError());
}
