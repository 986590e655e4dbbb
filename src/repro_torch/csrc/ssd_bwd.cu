// ssd_bwd: the gradient of the Mamba-2 chunked SSD scan (ssd.cu), float32.
//
// Replaces no Pallas kernel: the JAX package trains Mamba-2 and Zamba2 by
// differentiating its plain chunked scan (ssd_grouped_scan /
// ssd_chunked_ref, src/repro/kernels/ssd/ref.py) with autodiff.  This is
// that gradient written out in closed form, as the port's plain version
// ssd_chunked_bwd_ref (kernels/ssd/ref.py) computes it.  Per chunk c of q
// steps, with la = cumsum(dta) inside it, A = la_q, H_in the state entering
// the chunk, H_out = exp(A) H_in + s_c the state leaving it, and G the
// gradient of H_out (dh_final for the last chunk, else 0 there):
//
//     u_c  = (C * exp(la))^T dy,      G_{c-1} = exp(A_c) G_c + u_c
//     dx   = ((C B^T) o L)^T dy  + exp(A - la) (B G)
//     dC   = ((dy x^T) o L) B    + exp(la) (dy H_in^T)
//     dB   = ((dy x^T) o L)^T C  + exp(A - la) (x G^T)
//     dla_k = C_k . dC_k - B_k . dB_k  (+ <G, H_out> at the last step)
//     ddta  = the reverse cumulative sum of dla inside the chunk
//
// with L_ij = exp(la_i - la_j) for i >= j, else 0 (x = dtx).  Every
// exponent is <= 0, as in the forward: exp(la_i - la_j) for i >= j,
// exp(la_i) and exp(A - la_j), never exp(-la_j) alone.  Four kernels on one
// stream, mirroring the forward's three:
//
//   1. ssd_bwd_kernel_state, grid (chunks, heads, batch): u_c [N, P] into
//      float32 scratch [B, H, nc, N, P] (the forward's chunk-state body,
//      ssd.cuh, with the weights exp(la_j), C for B and dy for dtx);
//   2. ssd_bwd_kernel_pass, grid (batch * heads, N * P / 256): one thread
//      per state element runs G from the last chunk to the first and
//      overwrites slot c with G_c;
//   3. ssd_bwd_kernel_scan, grid (chunks, heads, batch): one chunk's dx,
//      dB, dC and ddta.  The entering states H_in are the forward's own
//      scratch (ssd.cu's pass kernel leaves slot c holding the state that
//      enters chunk c), saved by the autograd Function rather than
//      recomputed: 25 MB a layer at Mamba2-130m and 59 MB at Zamba2-7B
//      (S 4096), which remat keeps only while its layer is recomputed.
//      Its tiles: the lower triangle of (dy x^T) o L in shared memory, the
//      causal half of C B^T in registers while the state columns pass
//      32 at a time (C, B, H_in and G of 32 columns staged per pass, so
//      that N = 128 fits: 184 KB a block), then C B^T o L where (dy x^T) o L
//      was.  Thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 r of each
//      tile, as the forward's scan does.  dla needs no dx (B_k . dB_k =
//      x_k . dx_k), so ddta is written before dx;
//   4. ssd_bwd_kernel_headsum, when the heads share B and C (head stride 0,
//      as Mamba-2 passes them): kernel 3 writes each head's dB and dC into
//      scratch [B, H, S, N], and this sums the heads in order into
//      [B, S, N].  No atomics: two calls give the same bits.
//
// Constraints are the forward's: any chunk q <= 128 and a short last
// chunk, P <= 64, N <= 128, operands read through (batch, head, step)
// strides with unit stride along the last axis.
//
// What bounds it on an H100: at Zamba2-7B's training shape (112 heads,
// N = P = 64, S = 4096, q = 128) the work needed is ~30 GFLOP of float32
// multiply-adds (the causal halves of C B^T, once per batch, and per head
// of dy x^T and of the three products with L, and four N x P products a
// chunk) against ~360 MB of dta, dtx, dy, ddtx and the shared B, C, dB,
// dC: the float32 CUDA-core rate (67 TFLOP/s) bounds it at ~0.45 ms, the
// bytes at ~0.11 ms (kernels/cost.py: ssd_bwd_bound).  Float32 FMA on the
// CUDA cores, as the forward; one block of 256 threads an SM.
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

constexpr int NB = 32;             // state columns a pass of kernel 3 stages
constexpr int QP = QMAX + 1;       // pitch of the q x q tile
constexpr int NBP = NB + 1;        // pitch of the staged C and B columns
constexpr int PPMAX = PMAX + 1;    // the largest pitch of dy, x, H_in, G

// floats of kernel 3's shared memory (fixed: laid out for the largest
// shapes whatever the call's)
constexpr int SCAN_FLOATS = QMAX * QP + 2 * QMAX * PPMAX + 2 * QMAX * NBP +
                            2 * NB * PPMAX + 2 * QMAX + 32;

// 1. u_c = (C * exp(la))^T dy  ->  grads[b, h, c]
__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_kernel_state(const float* __restrict__ dta, Strides sa,
                     const float* __restrict__ dy, Strides sy,
                     const float* __restrict__ Cm, Strides sc,
                     float* __restrict__ grads, int heads, int S, int P,
                     int N, int Q, int vec) {
  ssd::chunk_outer<true>(dta, sa, dy, sy, Cm, sc, grads, nullptr, heads, S,
                         P, N, Q, vec);
}

// 2. over the chunks from the last: slot c <- G_c, the gradient of the state
//    leaving chunk c; G <- exp(la_q) G + u_c.  G starts from dh_final (or 0).
__global__ void __launch_bounds__(THREADS)
ssd_bwd_kernel_pass(float* __restrict__ grads,
                    const float* __restrict__ decay,
                    const float* __restrict__ dhfin, int nc, int NP) {
  const int e = blockIdx.y * THREADS + threadIdx.x;
  if (e >= NP) return;
  const long long bh = blockIdx.x;
  float* gp = grads + bh * nc * NP + e;
  const float* dec = decay + bh * nc;
  constexpr int AHEAD = 8;     // loads issued before the dependent updates
  float g = dhfin != nullptr ? dhfin[bh * NP + e] : 0.0f;
  for (int c0 = nc - 1; c0 >= 0; c0 -= AHEAD) {
    float u[AHEAD], a[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      if (c0 - k >= 0) {
        u[k] = gp[static_cast<long long>(c0 - k) * NP];
        a[k] = expf(dec[c0 - k]);
      }
    }
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      if (c0 - k >= 0) {
        gp[static_cast<long long>(c0 - k) * NP] = g;
        g = fmaf(a[k], g, u[k]);
      }
    }
  }
}

// The lower triangle of a q x q register tile times L into shared memory:
// t[i][j] = g[r][c] exp(la_i - la_j) for j <= i < q, else 0 (selected, not
// multiplied, so that no value of a row past the chunk leaks in)
__device__ __forceinline__ void store_tile(float* ts, const float (&g)[8][8],
                                           const float (&lai)[8],
                                           const float* la, int q, int tx,
                                           int ty) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int c = 0; c <= r; ++c) {
      const int j = tx + 16 * c;
      const bool live = j <= i && i < q;
      ts[i * QP + j] = live ? g[r][c] * expf(lai[r] - la[j]) : 0.0f;
    }
  }
}

// 3. one chunk's ddta, dx, dB and dC (dB and dC of this head alone)
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_kernel_scan(const float* __restrict__ dta, Strides sa,
                    const float* __restrict__ dtx, Strides sx,
                    const float* __restrict__ Bm, Strides sb,
                    const float* __restrict__ Cm, Strides sc,
                    const float* __restrict__ dy, Strides sy,
                    const float* __restrict__ states,
                    const float* __restrict__ grads,
                    const float* __restrict__ hfin,
                    float* __restrict__ ddta, Strides sda,
                    float* __restrict__ ddtx, Strides sdx,
                    float* __restrict__ dB, Strides sdb,
                    float* __restrict__ dC, Strides sdc, int heads, int S,
                    int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int pp = (P + 1) | 1;       // odd pitch: no bank conflicts
  float* ts = smem;                 // [QMAX][QP] (dy x^T) o L, then C B^T o L
  float* ys = ts + QMAX * QP;       // dy [QMAX][pp]
  float* xs = ys + QMAX * PPMAX;    // x [QMAX][pp]
  float* cs = xs + QMAX * PPMAX;    // C columns [QMAX][NBP]
  float* bs = cs + QMAX * NBP;      // B columns [QMAX][NBP]
  float* hs = bs + QMAX * NBP;      // H_in rows [NB][pp]
  float* gs = hs + NB * PPMAX;      // G rows [NB][pp]
  float* la = gs + NB * PPMAX;      // [QMAX]
  float* red = la + QMAX;           // [QMAX] dla by row
  float* wsum = red + QMAX;         // [32] the warps' parts of <G, H_out>

  const int c = blockIdx.x, nc = gridDim.x;
  const long long hi = blockIdx.y, bi = blockIdx.z;
  const int s0 = c * Q, q = min(Q, S - s0);
  dta += bi * sa.b + hi * sa.h + s0 * sa.s;
  dtx += bi * sx.b + hi * sx.h + s0 * sx.s;
  Bm += bi * sb.b + hi * sb.h + s0 * sb.s;
  Cm += bi * sc.b + hi * sc.h + s0 * sc.s;
  dy += bi * sy.b + hi * sy.h + s0 * sy.s;
  ddta += bi * sda.b + hi * sda.h + s0 * sda.s;
  ddtx += bi * sdx.b + hi * sdx.h + s0 * sdx.s;
  dB += bi * sdb.b + hi * sdb.h + s0 * sdb.s;
  dC += bi * sdc.b + hi * sdc.h + s0 * sdc.s;
  const int NP = N * P;
  const long long slot = (bi * heads + hi) * nc + c;
  const float* h_in = states + slot * NP;
  const float* g_out = grads + slot * NP;
  // the state leaving the chunk: the next slot, or the terminal state (only
  // needed when the last chunk's G, dh_final, is given)
  const float* h_out = c + 1 < nc ? states + (slot + 1) * NP
                       : hfin != nullptr ? hfin + (bi * heads + hi) * NP
                                         : nullptr;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (int e = q * pp + tid; e < QMAX * pp; e += THREADS) {
    ys[e] = 0.0f;               // rows past the chunk
    xs[e] = 0.0f;
  }
  stage(ys, pp, dy, sy.s, q, P, false);
  stage(xs, pp, dtx, sx.s, q, P, false);
  if (tid < 32) chunk_cumsum(dta, sa.s, q, la, tid);
  cp_async_wait_all();
  __syncthreads();
  if (tid >= q && tid < QMAX) la[tid] = la[q - 1];   // decay 1 past the end
  __syncthreads();
  const float A = la[q - 1];
  float lai[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) lai[r] = la[ty + 16 * r];

  // (dy x^T) o L over the lower triangle
  {
    float g[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int cc = 0; cc <= r; ++cc) g[r][cc] = 0.0f;
    for (int p = 0; p < P; ++p) {
      float yv[8], xv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        yv[k] = ys[(ty + 16 * k) * pp + p];
        xv[k] = xs[(tx + 16 * k) * pp + p];
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int cc = 0; cc <= r; ++cc) g[r][cc] = fmaf(yv[r], xv[cc], g[r][cc]);
    }
    store_tile(ts, g, lai, la, q, tx, ty);
  }

  float sacc[8][8];   // C B^T, causal half, over the passes
  float dxs[8][4];    // B G: rows j = ty + 16 r, columns p = tx + 16 cc
  float dl[8];        // C_k . dC_k - B_k . dB_k over this thread's columns
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    dl[r] = 0.0f;
#pragma unroll
    for (int cc = 0; cc <= r; ++cc) sacc[r][cc] = 0.0f;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) dxs[r][cc] = 0.0f;
  }
  for (int n0 = 0; n0 < N; n0 += NB) {
    const int nw = min(NB, N - n0);
    __syncthreads();            // the tile is written, the last pass read
    if (q < QMAX || nw < NB) {
      for (int e = tid; e < QMAX * NBP; e += THREADS) {
        cs[e] = 0.0f;
        bs[e] = 0.0f;
      }
      for (int e = tid; e < NB * PPMAX; e += THREADS) {
        hs[e] = 0.0f;
        gs[e] = 0.0f;
      }
      __syncthreads();
    }
    stage(cs, NBP, Cm + n0, sc.s, q, nw, false);
    stage(bs, NBP, Bm + n0, sb.s, q, nw, false);
    stage(hs, pp, h_in + n0 * P, P, nw, P, false);
    stage(gs, pp, g_out + n0 * P, P, nw, P, false);
    cp_async_wait_all();
    __syncthreads();

    // C B^T over these columns
    for (int n = 0; n < nw; ++n) {
      float cv[8], bv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        cv[k] = cs[(ty + 16 * k) * NBP + n];
        bv[k] = bs[(tx + 16 * k) * NBP + n];
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int cc = 0; cc <= r; ++cc)
          sacc[r][cc] = fmaf(cv[r], bv[cc], sacc[r][cc]);
    }

    // dC[i, n0 + tx + 16 cc] = exp(la_i) (dy H_in^T) + ((dy x^T) o L) B
    {
      float acc[8][2];
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r][0] = acc[r][1] = 0.0f;
      if (c > 0) {              // chunk 0 enters with H = 0
        for (int p = 0; p < P; ++p) {
          const float h0 = hs[tx * pp + p], h1 = hs[(tx + 16) * pp + p];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float yv = ys[(ty + 16 * r) * pp + p];
            acc[r][0] = fmaf(yv, h0, acc[r][0]);
            acc[r][1] = fmaf(yv, h1, acc[r][1]);
          }
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float e = expf(lai[r]);
          acc[r][0] *= e;
          acc[r][1] *= e;
        }
      }
      for (int jb = 0; jb * 16 < q; ++jb) {
        const int jn = min(16, q - jb * 16);
        for (int jj = 0; jj < jn; ++jj) {
          const int j = jb * 16 + jj;
          const float b0 = bs[j * NBP + tx], b1 = bs[j * NBP + tx + 16];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            if (r >= jb) {
              const float tv = ts[(ty + 16 * r) * QP + j];
              acc[r][0] = fmaf(tv, b0, acc[r][0]);
              acc[r][1] = fmaf(tv, b1, acc[r][1]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = ty + 16 * r;
        dl[r] = fmaf(cs[i * NBP + tx], acc[r][0], dl[r]);
        dl[r] = fmaf(cs[i * NBP + tx + 16], acc[r][1], dl[r]);
        if (i < q) {
          if (tx < nw) dC[i * sdc.s + n0 + tx] = acc[r][0];
          if (tx + 16 < nw) dC[i * sdc.s + n0 + tx + 16] = acc[r][1];
        }
      }
    }

    // dB[j, n0 + tx + 16 cc] = exp(A - la_j) (x G^T) + ((dy x^T) o L)^T C
    {
      float acc[8][2];
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r][0] = acc[r][1] = 0.0f;
      for (int p = 0; p < P; ++p) {
        const float g0 = gs[tx * pp + p], g1 = gs[(tx + 16) * pp + p];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float xv = xs[(ty + 16 * r) * pp + p];
          acc[r][0] = fmaf(xv, g0, acc[r][0]);
          acc[r][1] = fmaf(xv, g1, acc[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float e = expf(A - lai[r]);
        acc[r][0] *= e;
        acc[r][1] *= e;
      }
      for (int ib = 0; ib * 16 < q; ++ib) {
        const int in = min(16, q - ib * 16);
        for (int ii = 0; ii < in; ++ii) {
          const int i = ib * 16 + ii;
          const float c0 = cs[i * NBP + tx], c1 = cs[i * NBP + tx + 16];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            if (r <= ib) {
              const float tv = ts[i * QP + ty + 16 * r];
              acc[r][0] = fmaf(tv, c0, acc[r][0]);
              acc[r][1] = fmaf(tv, c1, acc[r][1]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int j = ty + 16 * r;
        dl[r] = fmaf(-bs[j * NBP + tx], acc[r][0], dl[r]);
        dl[r] = fmaf(-bs[j * NBP + tx + 16], acc[r][1], dl[r]);
        if (j < q) {
          if (tx < nw) dB[j * sdb.s + n0 + tx] = acc[r][0];
          if (tx + 16 < nw) dB[j * sdb.s + n0 + tx + 16] = acc[r][1];
        }
      }
    }

    // B G, the state term of dx, over these columns
    for (int n = 0; n < nw; ++n) {
      float gv[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int p = tx + 16 * cc;
        gv[cc] = p < P ? gs[n * pp + p] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float bv = bs[(ty + 16 * r) * NBP + n];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) dxs[r][cc] = fmaf(bv, gv[cc], dxs[r][cc]);
      }
    }
  }

  // dla by row: the 16 threads of a row (lanes tx of one half-warp) summed
  // in a fixed order; <G, H_out> summed over the block in a fixed order
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], off);
  float gh = 0.0f;
  if (h_out != nullptr)
    for (int e = tid; e < NP; e += THREADS) gh = fmaf(g_out[e], h_out[e], gh);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    gh += __shfl_xor_sync(0xffffffffu, gh, off);
  if (tid % 32 == 0) wsum[tid / 32] = gh;
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 8; ++r) red[ty + 16 * r] = dl[r];
  }
  __syncthreads();              // the passes are done: the tile is free

  store_tile(ts, sacc, lai, la, q, tx, ty);
  if (tid < 32) {
    // ddta[t] = sum of dla over t <= k < q: each lane four steps, then the
    // lanes above it
    const int lane = tid;
    float tot = 0.0f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) tot += wsum[w];
    float v[QMAX / 32];
    float run = 0.0f;
#pragma unroll
    for (int k = QMAX / 32 - 1; k >= 0; --k) {
      const int t = lane * (QMAX / 32) + k;
      run += t < q ? red[t] + (t == q - 1 ? tot : 0.0f) : 0.0f;
      v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += o;
    }
    const float excl = incl - run;
#pragma unroll
    for (int k = 0; k < QMAX / 32; ++k) {
      const int t = lane * (QMAX / 32) + k;
      if (t < q) ddta[t * sda.s] = v[k] + excl;
    }
  }
  __syncthreads();

  // dx[j, p] = exp(A - la_j) (B G) + ((C B^T) o L)^T dy
  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float e = expf(A - lai[r]);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[r][cc] = dxs[r][cc] * e;
  }
  for (int ib = 0; ib * 16 < q; ++ib) {
    const int in = min(16, q - ib * 16);
    for (int ii = 0; ii < in; ++ii) {
      const int i = ib * 16 + ii;
      float yv[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int p = tx + 16 * cc;
        yv[cc] = p < P ? ys[i * pp + p] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r <= ib) {
          const float tv = ts[i * QP + ty + 16 * r];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[r][cc] = fmaf(tv, yv[cc], acc[r][cc]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = ty + 16 * r;
    if (j >= q) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int p = tx + 16 * cc;
      if (p < P) ddtx[j * sdx.s + p] = acc[r][cc];
    }
  }
}

// 4. db[b, s, n] = sum over heads h in order of part_b[b, h, s, n]; likewise
//    dc (blockIdx.y = 1).  part_* are contiguous [B, H, S, N].
__global__ void __launch_bounds__(THREADS)
ssd_bwd_kernel_headsum(const float* __restrict__ part_b,
                       const float* __restrict__ part_c,
                       float* __restrict__ db, float* __restrict__ dc,
                       int heads, long long per_batch, long long total) {
  const long long e = blockIdx.x * static_cast<long long>(THREADS) +
                      threadIdx.x;
  if (e >= total) return;
  const float* src = blockIdx.y ? part_c : part_b;
  const long long bi = e / per_batch, r = e % per_batch;
  src += bi * heads * per_batch + r;
  float s = 0.0f;
  for (int h = 0; h < heads; ++h) s += src[h * per_batch];
  (blockIdx.y ? dc : db)[e] = s;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// Every strided tensor is float32 and indexed [batch, head, step(, last)]:
// the three strides of each (in elements) are passed, the last axis has unit
// stride.  dta [B, H, S], dtx / dy [B, H, S, P], Bm / Cm [B, H, S, N] (head
// stride 0 where the heads share them); outputs ddta [B, H, S], ddtx
// [B, H, S, P], and each head's dB / dC [B, H, S, N].  states [B*H*nc*N*P]
// and decay [B*H*nc] are the forward's scratch after its call (the state
// entering each chunk and each chunk's total log decay); hfin, the forward's
// terminal state [B*H, N, P], and dhfin, its gradient, are both given or
// both null.  grads [B*H*nc*N*P] is float32 scratch.  When db_sum and
// dc_sum are given ([B, S, N], contiguous), dB and dC must be contiguous
// [B, H, S, N] scratch, and the heads' sums go to db_sum and dc_sum.
extern "C" int ssd_bwd_launch(
    const void* dta, long long sa_b, long long sa_h, long long sa_s,
    const void* dtx, long long sx_b, long long sx_h, long long sx_s,
    const void* Bm, long long sb_b, long long sb_h, long long sb_s,
    const void* Cm, long long sc_b, long long sc_h, long long sc_s,
    const void* dy, long long sy_b, long long sy_h, long long sy_s,
    void* ddta, long long sda_b, long long sda_h, long long sda_s,
    void* ddtx, long long sdx_b, long long sdx_h, long long sdx_s,
    void* dB, long long sdb_b, long long sdb_h, long long sdb_s,
    void* dC, long long sdc_b, long long sdc_h, long long sdc_s,
    const void* states, const void* decay, const void* hfin,
    const void* dhfin, void* grads, void* db_sum, void* dc_sum, int batch,
    int heads, int S, int P, int N, int chunk, void* stream) {
  if (batch < 1 || heads < 1 || S < 1 || batch > 65535 || heads > 65535 ||
      !ssd::shape_ok(chunk, N, P) || states == nullptr || decay == nullptr ||
      grads == nullptr || (hfin == nullptr) != (dhfin == nullptr) ||
      (db_sum == nullptr) != (dc_sum == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_batch = static_cast<long long>(S) * N;
  if (db_sum != nullptr &&
      (sdb_b != heads * per_batch || sdb_h != per_batch || sdb_s != N ||
       sdc_b != sdb_b || sdc_h != sdb_h || sdc_s != sdb_s))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in = false;   // the largest shared memory, once
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_kernel_state, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(ssd::state_smem_bytes(QMAX, NMAX, PMAX)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          ssd_bwd_kernel_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(SCAN_FLOATS * sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = (S + chunk - 1) / chunk;
  const int vec = N % 4 == 0 && P % 4 == 0 &&
                  ssd::aligned16(dy, sy_b, sy_h, sy_s) &&
                  ssd::aligned16(Cm, sc_b, sc_h, sc_s);
  const Strides a{sa_b, sa_h, sa_s}, x{sx_b, sx_h, sx_s}, b{sb_b, sb_h, sb_s},
      c{sc_b, sc_h, sc_s}, y{sy_b, sy_h, sy_s}, oa{sda_b, sda_h, sda_s},
      ox{sdx_b, sdx_h, sdx_s}, ob{sdb_b, sdb_h, sdb_s},
      oc{sdc_b, sdc_h, sdc_s};
  const dim3 grid(nc, heads, batch);
  float* gp = static_cast<float*>(grads);
  ssd_bwd_kernel_state<<<grid, THREADS, ssd::state_smem_bytes(chunk, N, P),
                         st>>>(static_cast<const float*>(dta), a,
                               static_cast<const float*>(dy), y,
                               static_cast<const float*>(Cm), c, gp, heads,
                               S, P, N, chunk, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 pgrid(batch * heads, (N * P + THREADS - 1) / THREADS);
  ssd_bwd_kernel_pass<<<pgrid, THREADS, 0, st>>>(
      gp, static_cast<const float*>(decay),
      static_cast<const float*>(dhfin), nc, N * P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_kernel_scan<<<grid, THREADS, SCAN_FLOATS * sizeof(float), st>>>(
      static_cast<const float*>(dta), a, static_cast<const float*>(dtx), x,
      static_cast<const float*>(Bm), b, static_cast<const float*>(Cm), c,
      static_cast<const float*>(dy), y, static_cast<const float*>(states),
      gp, static_cast<const float*>(hfin), static_cast<float*>(ddta), oa,
      static_cast<float*>(ddtx), ox, static_cast<float*>(dB), ob,
      static_cast<float*>(dC), oc, heads, S, P, N, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || db_sum == nullptr) return static_cast<int>(err);
  const long long total = batch * per_batch;
  const dim3 hgrid(static_cast<unsigned>((total + THREADS - 1) / THREADS), 2);
  ssd_bwd_kernel_headsum<<<hgrid, THREADS, 0, st>>>(
      static_cast<const float*>(dB), static_cast<const float*>(dC),
      static_cast<float*>(db_sum), static_cast<float*>(dc_sum), heads,
      per_batch, total);
  return static_cast<int>(cudaGetLastError());
}
