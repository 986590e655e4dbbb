// ssd_bwd: the gradient of the Mamba-2 chunked SSD scan (ssd.cu), float32
// in and out, its products on the tensor cores as 3xTF32.
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
//     M1   = (dy x^T) o L,            M2 = (C B^T) o L
//     dx   = M2^T dy  + exp(A - la) (B G)
//     dC   = M1 B     + exp(la) (dy H_in^T)
//     dB   = M1^T C   + exp(A - la) (x G^T)
//     dla_k = C_k . dC_k - B_k . dB_k  (+ <G, H_out> at the last step)
//           = rowsum_k(M1 o C B^T) - colsum_k(M1 o C B^T)
//             + exp(la_k) dy_k . (C H_in)_k - exp(A - la_k) x_k . (B G)_k
//     ddta  = the reverse cumulative sum of dla inside the chunk
//
// with L_ij = exp(la_i - la_j) for i >= j, else 0 (x = dtx).  Every
// exponent is <= 0, as in the forward: exp(la_i - la_j) for i >= j,
// exp(la_i) and exp(A - la_j), never exp(-la_j) alone.  Four kernels on one
// stream, mirroring the forward's three:
//
//   1. ssd_bwd_kernel_state, grid (chunks, head groups, batch): u_c [N, P]
//      into float32 scratch [B, H, nc, N, P], on the tensor cores as kernel
//      3's products, C staged once for the group and each head's dy staged
//      behind the last head's products;
//   2. ssd_bwd_kernel_pass, grid (batch * heads, N * P / 256): one thread
//      per state element runs G from the last chunk to the first and
//      overwrites slot c with G_c;
//   3. ssd_bwd_kernel_scan, grid (chunks, head groups, batch): one chunk of
//      a group of G heads that share B and C (G = 1 where each head has its
//      own).  The entering states H_in are the forward's own scratch
//      (ssd.cu's pass kernel leaves slot c holding the state that enters
//      chunk c), saved by the autograd Function rather than recomputed.
//      C B^T is computed once for the group.  Per head: M1 = (dy x^T) o L,
//      whose sum over the group's heads is kept (dC and dB are linear in
//      M1 and B and C are shared, so the group's dC is (sum M1) B plus the
//      heads' state terms: two q x q x N products a group rather than a
//      head); dla from the row and column sums of M1 o C B^T and the state
//      terms' row dots; dx.  The heads' state terms of dC and dB go into
//      the group's partial [B, H/G, S, N] in head order (the block's own
//      rows: the first head stores, the others add), then (sum M1) B and
//      (sum M1)^T C are added.  Every product runs on the tensor cores in
//      mma.sync m16n8k8 TF32 with each float32 operand split as
//      hi = tf32(a) (rounded to nearest), lo = a - hi (truncated to TF32 by
//      the tensor cores): lo.hi + hi.lo, then hi.hi, into a float32
//      accumulator (lo.lo dropped), which keeps float32's accuracy
//      (tests/test_torch_ssd_bwd.py emulates it against jax.vjp); the decay
//      mask is selected, not multiplied, on the accumulator fragments, in
//      float32.  Eight warps; the triangular tiles are dealt out by pairs of
//      16-row strips (s, 7 - s), so that every warp takes the same share and
//      no warp branches inside an mma loop.  C B^T and the sum of M1 stay
//      in registers in the layout of the dy x^T fragments (36 floats a
//      thread each), the q x q tile that feeds a product (M2, then sum M1)
//      lives in shared memory as its packed lower triangle; the state
//      columns pass 64 at a time (C, B, H_in and G restaged per pass where
//      N > 64), the first pass's rows staged behind dy x^T.  226 KB of
//      shared memory, one block of 256 threads an SM;
//   4. ssd_bwd_kernel_headsum, when the heads share B and C (head stride 0,
//      as Mamba-2 passes them): sums the groups' partials in order into
//      [B, S, N].  No atomics: two calls give the same bits.
//
// Constraints are the forward's: any chunk q <= 128 and a short last
// chunk, P <= 64, N <= 128, operands read through (batch, head, step)
// strides with unit stride along the last axis.
//
// What bounds it on an H100: at Zamba2-7B's training shape (112 heads,
// N = P = 64, S = 4096, q = 128) the closed form's products come to ~23
// GFLOP (once per batch the causal halves of C B^T and of the head-summed
// masked tile's products with B and C; per head the causal halves of
// dy x^T and M2^T dy, and four N x P products a chunk) against ~360 MB of
// dta, dtx, dy, ddtx and the shared B, C, dB, dC: TF32 tensor cores at a
// third of their dense rate (3xTF32, 165 TFLOP/s) bound it at ~0.14 ms,
// the bytes at ~0.11 ms; the float32 CUDA cores would take ~0.34 ms
// (kernels/cost.py: ssd_bwd_bound).
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
using ssd::cp_async16;
using ssd::cp_async4;
using ssd::cp_async_wait_all;

constexpr int NS = 64;            // state columns a pass of kernel 3 holds
constexpr int TP = PMAX + 4;      // pitch of the [QMAX][64] tiles (4 mod 32)
constexpr int SP = NS + 8;        // pitch of the [NS][64] state rows (8 mod 32)
constexpr int WB = 20;            // pitch of a 16 x 16 block of the triangle
constexpr int WBLOCKS = (QMAX / 16) * (QMAX / 16 + 1) / 2;   // 36
constexpr int WARPS = THREADS / 32;

constexpr int UC = NMAX + 8;      // kernel 1's pitch of C, read transposed
constexpr int UY = PMAX + 8;      // kernel 1's pitch of dy
constexpr int STATE_FLOATS = QMAX * UC + 2 * QMAX * UY + 2 * QMAX;

// floats of kernel 3's shared memory (fixed: laid out for the largest
// shapes whatever the call's): C, B, dy and x tiles, H_in and G rows, the
// packed triangle, la, exp(la), exp(A - la), and dla's parts
constexpr int SCAN_FLOATS = 4 * QMAX * TP + 2 * NS * SP + WBLOCKS * 16 * WB +
                            3 * QMAX + 14 * QMAX + 32;
static_assert(NS == PMAX, "the C and B columns share the dy and x tiles' shape");
static_assert(SCAN_FLOATS * sizeof(float) <= 232448,
              "kernel 3 fits the 227 KB a block can take");

// ----------------------------------------------------------------------------
// 3xTF32 on mma.sync m16n8k8

struct FragA {   // rows g, g + 8 by columns t, t + 4 of a 16 x 8 tile
  uint32_t hi[4], lo[4];
};
struct FragB {   // rows t, t + 4 by column g of an 8 x 8 tile
  uint32_t hi[2], lo[2];
};

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds: half a unit of TF32's last place added to the
// magnitude, the low 13 bits cleared), lo = x - hi exactly, its low 13 bits
// left for the tensor cores to drop (lo truncated toward zero): two integer
// operations, cheaper to issue than two cvt.rna.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// one of 3xTF32's three terms: 0 lo.hi, 1 hi.lo, 2 hi.hi
__device__ __forceinline__ void mma_term(float (&d)[4], const FragA& a,
                                         const FragB& b, int term) {
  if (term == 0)
    mma_tf32(d, a.lo, b.hi);
  else if (term == 1)
    mma_tf32(d, a.hi, b.lo);
  else
    mma_tf32(d, a.hi, b.hi);
}

// A(m, k) for m in m0 + {g, g + 8}, k in k0 + {t, t + 4}
template <class F>
__device__ __forceinline__ FragA load_a(F at, int m0, int k0, int g, int t) {
  FragA f;
  split(at(m0 + g, k0 + t), f.hi[0], f.lo[0]);
  split(at(m0 + g + 8, k0 + t), f.hi[1], f.lo[1]);
  split(at(m0 + g, k0 + t + 4), f.hi[2], f.lo[2]);
  split(at(m0 + g + 8, k0 + t + 4), f.hi[3], f.lo[3]);
  return f;
}

// B(k, n) for k in k0 + {t, t + 4}, n = n0 + g
template <class F>
__device__ __forceinline__ FragB load_b(F at, int k0, int n0, int g, int t) {
  FragB f;
  split(at(k0 + t, n0 + g), f.hi[0], f.lo[0]);
  split(at(k0 + t + 4, n0 + g), f.hi[1], f.lo[1]);
  return f;
}

// ----------------------------------------------------------------------------
// How the warps share the tiles.  Warp w takes the 16-row strips a = w % 4
// and 7 - a, and half = w / 4 of what those strips hold.
//
// The lower triangle of a q x q tile ("tri"): strip s holds the 16 x 8 tiles
// 0 .. 2s + 1; warp w takes tiles half, half + 2, ... of both of its strips,
// nine in all (its accumulator acc[9][4]).  Element r of tile idx lies at
// row 16 s + g + 8 (r / 2), column 8 tt + 2 t + r % 2.
__host__ __device__ constexpr void tri_tile(int idx, int a, int half,
                                            int& s, int& tt) {
  if (idx <= a) {
    s = a;
    tt = 2 * idx + half;
  } else {
    s = 7 - a;
    tt = 2 * (idx - a - 1) + half;
  }
}

// acc += A B over the lower triangle's tiles, depth K (a multiple of 8).
// Each product is three HMMAs on one accumulator (3xTF32: the small terms
// first, then the large one); they are issued a term at a time over three
// tiles, so that no HMMA waits on the one before it.
template <int A, class FA, class FB>
__device__ __forceinline__ void tri_product_a(float (&acc)[9][4], FA a_at,
                                              FB b_at, int K, int half,
                                              int g, int t) {
  for (int k0 = 0; k0 < K; k0 += 8) {
    const FragA f[2] = {load_a(a_at, 16 * A, k0, g, t),
                        load_a(a_at, 16 * (7 - A), k0, g, t)};
#pragma unroll
    for (int i0 = 0; i0 < 9; i0 += 3) {
      FragB fb[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        int s, tt;
        tri_tile(i0 + j, A, half, s, tt);
        fb[j] = load_b(b_at, k0, 8 * tt, g, t);
      }
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          mma_term(acc[i0 + j], f[i0 + j <= A ? 0 : 1], fb[j], term);
    }
  }
}

template <class FA, class FB>
__device__ __forceinline__ void tri_product(float (&acc)[9][4], FA a_at,
                                            FB b_at, int K, int a, int half,
                                            int g, int t) {
  switch (a) {
    case 0: tri_product_a<0>(acc, a_at, b_at, K, half, g, t); break;
    case 1: tri_product_a<1>(acc, a_at, b_at, K, half, g, t); break;
    case 2: tri_product_a<2>(acc, a_at, b_at, K, half, g, t); break;
    default: tri_product_a<3>(acc, a_at, b_at, K, half, g, t); break;
  }
}

// A q x 64 output ("rect"): warp w takes its two strips (sp 0: a, sp 1:
// 7 - a) by the 8-column tiles 4 half .. 4 half + 3 (acc[2][4][4]).
// Element r of acc[sp][u] lies at row m0(sp) + g + 8 (r / 2), column
// 8 (4 half + u) + 2 t + r % 2.
__device__ __forceinline__ int strip_row(int sp, int a) {
  return 16 * (sp ? 7 - a : a);
}

// acc += A B at depth K (a multiple of 8), the B fragments shared by the
// two strips, the terms interleaved over the eight tiles
template <class FA, class FB>
__device__ __forceinline__ void rect_dense(float (&acc)[2][4][4], FA a_at,
                                           FB b_at, int K, int a, int half,
                                           int g, int t) {
  for (int k0 = 0; k0 < K; k0 += 8) {
    const FragA f0 = load_a(a_at, strip_row(0, a), k0, g, t);
    const FragA f1 = load_a(a_at, strip_row(1, a), k0, g, t);
    FragB fb[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      fb[u] = load_b(b_at, k0, 8 * (4 * half + u), g, t);
#pragma unroll
    for (int term = 0; term < 3; ++term)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        mma_term(acc[0][u], f0, fb[u], term);
        mma_term(acc[1][u], f1, fb[u], term);
      }
  }
}

// acc += A B over a triangular depth: strip sp takes k in [klo[sp], khi[sp]);
// the terms interleaved over the strip's four tiles
template <class FA, class FB>
__device__ __forceinline__ void rect_tri(float (&acc)[2][4][4], FA a_at,
                                         FB b_at, const int (&klo)[2],
                                         const int (&khi)[2], int a, int half,
                                         int g, int t) {
#pragma unroll
  for (int sp = 0; sp < 2; ++sp) {
    const int m0 = strip_row(sp, a);
    for (int k0 = klo[sp]; k0 < khi[sp]; k0 += 8) {
      const FragA fa = load_a(a_at, m0, k0, g, t);
      FragB fb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        fb[u] = load_b(b_at, k0, 8 * (4 * half + u), g, t);
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int u = 0; u < 4; ++u) mma_term(acc[sp][u], fa, fb[u], term);
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most `kLeft` committed groups of this thread are in flight
template <int kLeft>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kLeft) : "memory");
}

// One warp: the chunk's dta, four steps a lane (lane l steps 4 l .. 4 l + 3)
__device__ __forceinline__ void load_dta(float (&v)[QMAX / 32],
                                         const float* dta, long long ss,
                                         int q, int lane) {
#pragma unroll
  for (int k = 0; k < QMAX / 32; ++k) {
    const int i = lane * (QMAX / 32) + k;
    v[k] = i < q ? dta[i * ss] : 0.0f;
  }
}

// One warp: e[i] = exp(la_i), la = the cumulative sum of the steps load_dta
// read, for i < q (as ssd::chunk_cumsum sums), and 0 for q <= i < QMAX: the
// products run to depth round8(q), and stale shared memory there (an Inf
// or NaN another kernel left) would reach them as 0 x Inf
__device__ __forceinline__ void exp_cumsum(const float (&v)[QMAX / 32],
                                           int q, float* e, int lane) {
  float la[QMAX / 32];
  float run = 0.0f;
#pragma unroll
  for (int k = 0; k < QMAX / 32; ++k) {
    run += v[k];
    la[k] = run;
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
    const int i = lane * (QMAX / 32) + k;
    e[i] = i < q ? expf(la[k] + excl) : 0.0f;
  }
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&v)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) v[i][j] = 0.0f;
}

__device__ __forceinline__ void zero(float (&v)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) zero(v[i]);
}

// The packed lower triangle of a q x q tile: 16 x 16 block (bi, bj), bj <= bi,
// at index bi (bi + 1) / 2 + bj, rows WB floats apart
__device__ __forceinline__ int tri_index(int i, int j) {
  const int bi = i >> 4;
  return ((bi * (bi + 1) / 2 + (j >> 4)) * 16 + (i & 15)) * WB + (j & 15);
}

// Copies rows [0, rows) x columns [0, COLS) of a tile whose rows lie
// `sstride` floats apart into shared memory rows `pitch` floats apart:
// src[r][c] for r < rv and c < cv, zero elsewhere; cp.async, 16 bytes at a
// time where `vec` (src and its stride 16-byte aligned) and the four
// columns are all in.
template <int COLS>
__device__ __forceinline__ void stage_zero(float* dst, int pitch,
                                           const float* src, long long sstride,
                                           int rows, int rv, int cv, bool vec) {
  constexpr int W = COLS / 4;
  for (int e = threadIdx.x; e < rows * W; e += THREADS) {
    const int r = e / W, c = (e % W) * 4;
    float* d = dst + r * pitch + c;
    const float* s = src + r * sstride + c;
    if (vec && r < rv && c + 4 <= cv) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (r < rv && c + k < cv)
          cp_async4(d + k, s + k);
        else
          d[k] = 0.0f;
      }
    }
  }
}

// out[i][n0 + n] (+)= scale_i acc for the rows i < q and columns n0 + n <
// ncols of a rect accumulator; stores where `first`, else adds to what this
// thread stored before.  Every load is issued before the first store: the
// rows lie a run-time stride apart, so a store could alias a later load,
// and loads between the stores would each wait out a round trip to L2.
__device__ __forceinline__ void put_rows(float* out, long long ss,
                                         const float (&acc)[2][4][4],
                                         const float* scale, int n0, int q,
                                         int ncols, bool first, int a,
                                         int half, int g, int t) {
  float old[2][4][4];
#pragma unroll
  for (int sp = 0; sp < 2; ++sp)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = strip_row(sp, a) + g + 8 * (e / 2);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n = n0 + 8 * (4 * half + u) + 2 * t + e % 2;
        old[sp][u][e] = !first && i < q && n < ncols ? out[i * ss + n] : 0.0f;
      }
    }
#pragma unroll
  for (int sp = 0; sp < 2; ++sp)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = strip_row(sp, a) + g + 8 * (e / 2);
      const float w = scale != nullptr && i < q ? scale[i] : 1.0f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n = n0 + 8 * (4 * half + u) + 2 * t + e % 2;
        if (i < q && n < ncols) out[i * ss + n] = fmaf(acc[sp][u][e], w,
                                                       old[sp][u][e]);
      }
    }
}

// The row dots of a rect accumulator with a [QMAX][TP] tile, summed over
// the quad (the four lanes of a row): part[sp][r] for row
// strip_row(sp) + g + 8 r
__device__ __forceinline__ void row_dots(float (&part)[2][2],
                                         const float (&acc)[2][4][4],
                                         const float* tile, int a, int half,
                                         int g, int t) {
#pragma unroll
  for (int sp = 0; sp < 2; ++sp)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = strip_row(sp, a) + g + 8 * r;
      float v = 0.0f;
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
          v = fmaf(tile[i * TP + 8 * (4 * half + u) + 2 * t + cc],
                   acc[sp][u][2 * r + cc], v);
      part[sp][r] += v;
    }
}

// ----------------------------------------------------------------------------

// 1. u_c = (C * exp(la))^T dy  ->  grads[b, h, c] [N, P], on the tensor
//    cores (3xTF32) at depth q, for a chunk and a group of heads that share
//    C (staged once): each head's dy staged behind the last head's
//    products (two buffers).  Warp w takes the output rows 16 (w % 4) and,
//    where N > 64, 64 + 16 (w % 4), by the 8-column tiles 4 (w / 4) ..
//    4 (w / 4) + 3; C is read transposed, dy times exp(la) as it is read.
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_kernel_state(const float* __restrict__ dta, Strides sa,
                     const float* __restrict__ dy, Strides sy,
                     const float* __restrict__ Cm, Strides sc,
                     float* __restrict__ grads, int heads, int group, int S,
                     int P, int N, int Q, int vec_c, int vec_y) {
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                  // C [QMAX][UC]
  float* ybuf = cs + QMAX * UC;      // dy [2][QMAX][UY]
  float* ebuf = ybuf + 2 * QMAX * UY;  // exp(la) [2][QMAX]
  const int c = blockIdx.x, nc = gridDim.x, grp = blockIdx.y;
  const long long bi = blockIdx.z;
  const int h0 = grp * group, hn = min(group, heads - h0);
  const int s0 = c * Q, q = min(Q, S - s0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4, strip = warp % 4, half = warp / 4;
  const int kq = (q + 7) & ~7;
  // head hh's dy into buffer hh % 2; its steps' dta into registers of
  // warp 0, whose exp(la) goes to buffer hh % 2 after the last head's
  // products
  float dv[QMAX / 32];
  auto stage_head = [&](int hh) {
    const long long hi = h0 + hh;
    stage_zero<PMAX>(ybuf + (hh % 2) * QMAX * UY, UY,
                     dy + bi * sy.b + hi * sy.h + s0 * sy.s, sy.s, QMAX, q, P,
                     vec_y);
    if (warp == 0)
      load_dta(dv, dta + bi * sa.b + hi * sa.h + s0 * sa.s, sa.s, q, lane);
  };
  stage_zero<NMAX>(cs, UC, Cm + bi * sc.b + h0 * sc.h + s0 * sc.s, sc.s,
                   QMAX, q, N, vec_c);
  stage_head(0);
  cp_async_commit();
  if (warp == 0) exp_cumsum(dv, q, ebuf, lane);
  auto ct_at = [=](int n, int i) { return cs[i * UC + n]; };
  for (int hh = 0; hh < hn; ++hh) {
    if (hh + 1 < hn) stage_head(hh + 1);
    cp_async_commit();
    cp_async_wait<1>();              // this head's dy (and C)
    __syncthreads();
    const float* ys = ybuf + (hh % 2) * QMAX * UY;
    const float* ev = ebuf + (hh % 2) * QMAX;
    auto y_at = [=](int i, int p) { return ys[i * UY + p] * ev[i]; };
    float acc[2][4][4];
    zero(acc);
    for (int k0 = 0; k0 < kq; k0 += 8) {
      FragB fb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        fb[u] = load_b(y_at, k0, 8 * (4 * half + u), g, t);
      const FragA f0 = load_a(ct_at, 16 * strip, k0, g, t);
      if (N > 64) {
        const FragA f1 = load_a(ct_at, 64 + 16 * strip, k0, g, t);
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            mma_term(acc[0][u], f0, fb[u], term);
            mma_term(acc[1][u], f1, fb[u], term);
          }
      } else {
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int u = 0; u < 4; ++u) mma_term(acc[0][u], f0, fb[u], term);
      }
    }
    float* out = grads + ((bi * heads + h0 + hh) * nc + c) * N * P;
#pragma unroll
    for (int sp = 0; sp < 2; ++sp)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 64 * sp + 16 * strip + g + 8 * (e / 2);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int p = 8 * (4 * half + u) + 2 * t + e % 2;
          if (n < N && p < P) out[n * P + p] = acc[sp][u][e];
        }
      }
    if (warp == 0 && hh + 1 < hn)
      exp_cumsum(dv, q, ebuf + ((hh + 1) % 2) * QMAX, lane);
    __syncthreads();                 // this buffer is read: the next stages
  }
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

// 3. one chunk of a head group: each head's ddta and dx, the group's dB and
//    dC (into part_b / part_c, strides sdb / sdc with the group for the head)
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
                    float* part_b, Strides sdb, float* part_c, Strides sdc,
                    int heads, int group, int S, int P, int N, int Q,
                    int vec_bc, int vec_xy, int vec_st) {
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                  // C columns [QMAX][TP]
  float* bs = cs + QMAX * TP;        // B columns [QMAX][TP]
  float* ys = bs + QMAX * TP;        // dy [QMAX][TP]
  float* xs = ys + QMAX * TP;        // x [QMAX][TP]
  float* hs = xs + QMAX * TP;        // H_in rows [NS][SP]
  float* gs = hs + NS * SP;          // G rows [NS][SP]
  float* ws = gs + NS * SP;          // M2, then sum M1: packed triangle
  float* la = ws + WBLOCKS * 16 * WB;  // [QMAX]
  float* ev = la + QMAX;             // exp(la)
  float* fv = ev + QMAX;             // exp(A - la)
  float* rowt = fv + QMAX;           // [2][QMAX] rowsum(M1 o C B^T) by half
  float* colt = rowt + 2 * QMAX;     // [8][QMAX] colsum by strip
  float* stc = colt + 8 * QMAX;      // [2][QMAX] exp(la) dy . (C H_in)
  float* stb = stc + 2 * QMAX;       // [2][QMAX] exp(A - la) x . (B G)
  float* wsum = stb + 2 * QMAX;      // [WARPS] the warps' parts of <G, H_out>

  const int c = blockIdx.x, nc = gridDim.x, grp = blockIdx.y;
  const long long bi = blockIdx.z;
  const int h0 = grp * group, hn = min(group, heads - h0);
  const int s0 = c * Q, q = min(Q, S - s0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4, a = warp % 4, half = warp / 4;
  const int NP = N * P;
  const int kp = (P + 7) & ~7, kq = (q + 7) & ~7;
  const bool passes = N > NS;        // C and B restaged for every use
  const float* bsrc = Bm + bi * sb.b + h0 * sb.h + s0 * sb.s;
  const float* csrc = Cm + bi * sc.b + h0 * sc.h + s0 * sc.s;
  part_b += bi * sdb.b + grp * sdb.h + s0 * sdb.s;
  part_c += bi * sdc.b + grp * sdc.h + s0 * sdc.s;

  auto c_at = [=](int i, int n) { return cs[i * TP + n]; };
  auto b_at = [=](int j, int n) { return bs[j * TP + n]; };
  auto bt_at = [=](int n, int j) { return bs[j * TP + n]; };
  auto y_at = [=](int i, int p) { return ys[i * TP + p]; };
  auto x_at = [=](int j, int p) { return xs[j * TP + p]; };
  auto xt_at = [=](int p, int j) { return xs[j * TP + p]; };
  auto h_at = [=](int n, int p) { return hs[n * SP + p]; };
  auto ht_at = [=](int p, int n) { return hs[n * SP + p]; };
  auto g_at = [=](int n, int p) { return gs[n * SP + p]; };
  auto gt_at = [=](int p, int n) { return gs[n * SP + p]; };
  auto w_at = [=](int i, int j) { return ws[tri_index(i, j)]; };
  auto wt_at = [=](int j, int i) { return ws[tri_index(i, j)]; };
  auto stage_bc = [=](int n0) {
    const int nw = min(NS, N - n0);
    stage_zero<NS>(cs, TP, csrc + n0, sc.s, QMAX, q, nw, vec_bc);
    stage_zero<NS>(bs, TP, bsrc + n0, sb.s, QMAX, q, nw, vec_bc);
  };

  // C B^T once for the group, over the state columns
  float cb[9][4];
  zero(cb);
  for (int n0 = 0; n0 < N; n0 += NS) {
    if (n0 > 0) __syncthreads();
    stage_bc(n0);
    cp_async_wait_all();
    __syncthreads();
    tri_product(cb, c_at, bt_at, (min(NS, N - n0) + 7) & ~7, a, half, g, t);
  }

  float msum[9][4];                  // sum of M1 over the group's heads
  zero(msum);
  for (int hh = 0; hh < hn; ++hh) {
    const long long hi = h0 + hh;
    const float* dta_h = dta + bi * sa.b + hi * sa.h + s0 * sa.s;
    const long long slot = (bi * heads + hi) * nc + c;
    const float* h_in = states + slot * NP;
    const float* g_out = grads + slot * NP;
    // the state leaving the chunk: the next slot, or the terminal state
    // (only needed when the last chunk's G, dh_final, is given)
    const float* h_out = c + 1 < nc ? states + (slot + 1) * NP
                         : hfin != nullptr ? hfin + (bi * heads + hi) * NP
                                           : nullptr;
    auto stage_state = [=](int n0) {
      const int nw = min(NS, N - n0);
      stage_zero<PMAX>(hs, SP, h_in + n0 * P, P, NS, nw, P, vec_st);
      stage_zero<PMAX>(gs, SP, g_out + n0 * P, P, NS, nw, P, vec_st);
    };
    __syncthreads();                 // the last head's reads are done
    stage_zero<PMAX>(ys, TP, dy + bi * sy.b + hi * sy.h + s0 * sy.s, sy.s, QMAX,
               q, P, vec_xy);
    stage_zero<PMAX>(xs, TP, dtx + bi * sx.b + hi * sx.h + s0 * sx.s, sx.s, QMAX,
               q, P, vec_xy);
    cp_async_commit();
    // the first pass's H_in and G rows (and C and B columns where they
    // pass), in flight behind dy x^T
    if (passes) stage_bc(0);
    stage_state(0);
    cp_async_commit();
    if (warp == 0) chunk_cumsum(dta_h, sa.s, q, la, lane);
    cp_async_wait<1>();
    __syncthreads();
    if (tid >= q && tid < QMAX) la[tid] = la[q - 1];   // decay 1 past the end
    __syncthreads();
    const float A = la[q - 1];
    if (tid < QMAX) {
      ev[tid] = expf(la[tid]);
      fv[tid] = expf(A - la[tid]);
    }

    // M1 = (dy x^T) o L; its products with C B^T for dla; M2 = C B^T o L
    {
      float s1[9][4];
      zero(s1);
      tri_product(s1, y_at, xt_at, kp, a, half, g, t);
      float rsum[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
      for (int idx = 0; idx < 9; ++idx) {
        int s, tt;
        tri_tile(idx, a, half, s, tt);
        const int sp = idx <= a ? 0 : 1;
        float csum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 16 * s + g + 8 * r;
          const float lai = la[i];
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int j = 8 * tt + 2 * t + cc;
            const int e = 2 * r + cc;
            const float l = j <= i ? expf(lai - la[j]) : 0.0f;
            const float m1 = s1[idx][e] * l;
            const float tv = m1 * cb[idx][e];
            if (sp == 0)
              rsum[0][r] += tv;
            else
              rsum[1][r] += tv;
            csum[cc] += tv;
            msum[idx][e] += m1;
            ws[tri_index(i, j)] = cb[idx][e] * l;
          }
        }
        // the column sums over the tile's 16 rows: the 8 lanes of a column
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            csum[cc] += __shfl_xor_sync(0xffffffffu, csum[cc], off);
        }
        if (g == 0) {
          colt[s * QMAX + 8 * tt + 2 * t] = csum[0];
          colt[s * QMAX + 8 * tt + 2 * t + 1] = csum[1];
        }
      }
#pragma unroll
      for (int sp = 0; sp < 2; ++sp)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float v = rsum[sp][r];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (t == 0) rowt[half * QMAX + strip_row(sp, a) + g + 8 * r] = v;
        }
    }

    // the state terms, 64 state columns a pass: C H_in (its row dots with
    // dy), B G (dx's), and the group's exp(la) dy H_in^T and
    // exp(A - la) x G^T into dC's and dB's partials
    float dx[2][4][4];
    zero(dx);
    float rc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    for (int n0 = 0; n0 < N; n0 += NS) {
      const int nw = min(NS, N - n0), kn = (nw + 7) & ~7;
      if (n0 > 0) {
        __syncthreads();             // the last pass's reads are done
        stage_bc(n0);
        stage_state(n0);
      }
      cp_async_wait_all();
      __syncthreads();               // this pass's rows; the triangle
      float acc[2][4][4];
      zero(acc);
      rect_dense(acc, c_at, h_at, kn, a, half, g, t);
      row_dots(rc, acc, ys, a, half, g, t);
      rect_dense(dx, b_at, g_at, kn, a, half, g, t);
      zero(acc);
      rect_dense(acc, y_at, ht_at, kp, a, half, g, t);
      put_rows(part_c, sdc.s, acc, ev, n0, q, N, hh == 0, a, half, g, t);
      zero(acc);
      rect_dense(acc, x_at, gt_at, kp, a, half, g, t);
      put_rows(part_b, sdb.s, acc, fv, n0, q, N, hh == 0, a, half, g, t);
    }
    float rb[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    row_dots(rb, dx, xs, a, half, g, t);
#pragma unroll
    for (int sp = 0; sp < 2; ++sp)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float vc = rc[sp][r], vb = rb[sp][r];
        vc += __shfl_xor_sync(0xffffffffu, vc, 1);
        vc += __shfl_xor_sync(0xffffffffu, vc, 2);
        vb += __shfl_xor_sync(0xffffffffu, vb, 1);
        vb += __shfl_xor_sync(0xffffffffu, vb, 2);
        const int i = strip_row(sp, a) + g + 8 * r;
        const float f = fv[i];
        if (t == 0) {
          stc[half * QMAX + i] = vc * ev[i];
          stb[half * QMAX + i] = vb * f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          dx[sp][u][2 * r] *= f;
          dx[sp][u][2 * r + 1] *= f;
        }
      }

    // dx = exp(A - la) (B G) + M2^T dy, M2's rows i >= j
    {
      const int klo[2] = {strip_row(0, a), strip_row(1, a)};
      const int khi[2] = {kq, kq};
      rect_tri(dx, wt_at, y_at, klo, khi, a, half, g, t);
      float* out = ddtx + bi * sdx.b + hi * sdx.h + s0 * sdx.s;
#pragma unroll
      for (int sp = 0; sp < 2; ++sp)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = strip_row(sp, a) + g + 8 * r;
          if (j >= q) continue;
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int p = 8 * (4 * half + u) + 2 * t + cc;
              if (p < P) out[j * sdx.s + p] = dx[sp][u][2 * r + cc];
            }
        }
    }

    // <G, H_out>, summed over the block in a fixed order
    float gh = 0.0f;
    if (h_out != nullptr)
      for (int e = tid; e < NP; e += THREADS) gh = fmaf(g_out[e], h_out[e], gh);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      gh += __shfl_xor_sync(0xffffffffu, gh, off);
    if (lane == 0) wsum[warp] = gh;
    __syncthreads();
    if (warp == 0) {
      // dla by step, then ddta[k] = the sum of dla over k <= k' < q: each
      // lane four steps, then the lanes above it
      float tot = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) tot += wsum[w];
      float v[QMAX / 32];
      float run = 0.0f;
#pragma unroll
      for (int k = QMAX / 32 - 1; k >= 0; --k) {
        const int i = lane * (QMAX / 32) + k;
        float d = 0.0f;
        if (i < q) {
          d = rowt[i] + rowt[QMAX + i] + stc[i] + stc[QMAX + i] - stb[i] -
              stb[QMAX + i];
          for (int s = i / 16; s < QMAX / 16; ++s) d -= colt[s * QMAX + i];
          if (i == q - 1) d += tot;
        }
        run += d;
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += o;
      }
      const float excl = incl - run;
      float* out = ddta + bi * sda.b + hi * sda.h + s0 * sda.s;
#pragma unroll
      for (int k = 0; k < QMAX / 32; ++k) {
        const int i = lane * (QMAX / 32) + k;
        if (i < q) out[i * sda.s] = v[k] + excl;
      }
    }
  }

  // the group's dC += (sum M1) B and dB += (sum M1)^T C
  __syncthreads();                   // the last head's reads are done
#pragma unroll
  for (int idx = 0; idx < 9; ++idx) {
    int s, tt;
    tri_tile(idx, a, half, s, tt);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ws[tri_index(16 * s + g + 8 * (e / 2), 8 * tt + 2 * t + e % 2)] =
          msum[idx][e];
  }
  for (int n0 = 0; n0 < N; n0 += NS) {
    if (passes) {
      __syncthreads();
      stage_bc(n0);
      cp_async_wait_all();
    }
    __syncthreads();
    float acc[2][4][4];
    zero(acc);
    {
      const int klo[2] = {0, 0};
      const int khi[2] = {min(strip_row(0, a) + 16, kq),
                          min(strip_row(1, a) + 16, kq)};
      rect_tri(acc, w_at, b_at, klo, khi, a, half, g, t);
    }
    put_rows(part_c, sdc.s, acc, nullptr, n0, q, N, false, a, half, g, t);
    zero(acc);
    {
      const int klo[2] = {strip_row(0, a), strip_row(1, a)};
      const int khi[2] = {kq, kq};
      rect_tri(acc, wt_at, c_at, klo, khi, a, half, g, t);
    }
    put_rows(part_b, sdb.s, acc, nullptr, n0, q, N, false, a, half, g, t);
  }
}

// 4. db[b, s, n] = sum over groups k in order of part_b[b, k, s, n];
//    likewise dc (blockIdx.y = 1).  part_* are contiguous [B, groups, S, N].
__global__ void __launch_bounds__(THREADS)
ssd_bwd_kernel_headsum(const float* __restrict__ part_b,
                       const float* __restrict__ part_c,
                       float* __restrict__ db, float* __restrict__ dc,
                       int groups, long long per_batch, long long total) {
  const long long e = blockIdx.x * static_cast<long long>(THREADS) +
                      threadIdx.x;
  if (e >= total) return;
  const float* src = blockIdx.y ? part_c : part_b;
  const long long bi = e / per_batch, r = e % per_batch;
  src += bi * groups * per_batch + r;
  float s = 0.0f;
  for (int k = 0; k < groups; ++k) s += src[k * per_batch];
  (blockIdx.y ? dc : db)[e] = s;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// Every strided tensor is float32 and indexed [batch, head, step(, last)]:
// the three strides of each (in elements) are passed, the last axis has unit
// stride.  dta [B, H, S], dtx / dy [B, H, S, P], Bm / Cm [B, H, S, N] (head
// stride 0 where the heads share them); outputs ddta [B, H, S], ddtx
// [B, H, S, P].  states [B*H*nc*N*P] and decay [B*H*nc] are the forward's
// scratch after its call (the state entering each chunk and each chunk's
// total log decay); hfin, the forward's terminal state [B*H, N, P], and
// dhfin, its gradient, are both given or both null.  grads [B*H*nc*N*P] is
// float32 scratch.  `group` heads share a block of the scan (more than 1
// only where Bm and Cm have head stride 0).  When db_sum and dc_sum are
// given ([B, S, N], contiguous), dB and dC must be contiguous
// [B, ceil(H / group), S, N] scratch for the groups' partials, whose sums
// go to db_sum and dc_sum; otherwise group is 1 and dB / dC [B, H, S, N]
// take each head's gradients.
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
    int heads, int S, int P, int N, int chunk, int group, void* stream) {
  if (batch < 1 || heads < 1 || S < 1 || batch > 65535 || heads > 65535 ||
      group < 1 || !ssd::shape_ok(chunk, N, P) || states == nullptr ||
      decay == nullptr || grads == nullptr ||
      (hfin == nullptr) != (dhfin == nullptr) ||
      (db_sum == nullptr) != (dc_sum == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (heads + group - 1) / group;
  const long long per_batch = static_cast<long long>(S) * N;
  if (group > 1 && (sb_h != 0 || sc_h != 0 || db_sum == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (db_sum != nullptr &&
      (sdb_b != groups * per_batch || sdb_h != per_batch || sdb_s != N ||
       sdc_b != sdb_b || sdc_h != sdb_h || sdc_s != sdb_s))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in = false;   // the largest shared memory, once
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_kernel_state, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(STATE_FLOATS * sizeof(float)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          ssd_bwd_kernel_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(SCAN_FLOATS * sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = (S + chunk - 1) / chunk;
  const int vec_bc = ssd::aligned16(Bm, sb_b, sb_h, sb_s) &&
                     ssd::aligned16(Cm, sc_b, sc_h, sc_s);
  const int vec_xy = ssd::aligned16(dy, sy_b, sy_h, sy_s) &&
                     ssd::aligned16(dtx, sx_b, sx_h, sx_s);
  const int vec_st = P % 4 == 0 && ssd::aligned16(states, 0, 0, 0) &&
                     ssd::aligned16(grads, 0, 0, 0);
  const Strides a{sa_b, sa_h, sa_s}, x{sx_b, sx_h, sx_s}, b{sb_b, sb_h, sb_s},
      c{sc_b, sc_h, sc_s}, y{sy_b, sy_h, sy_s}, oa{sda_b, sda_h, sda_s},
      ox{sdx_b, sdx_h, sdx_s}, ob{sdb_b, sdb_h, sdb_s},
      oc{sdc_b, sdc_h, sdc_s};
  const dim3 sgrid(nc, groups, batch);
  float* gp = static_cast<float*>(grads);
  ssd_bwd_kernel_state<<<sgrid, THREADS, STATE_FLOATS * sizeof(float), st>>>(
      static_cast<const float*>(dta), a, static_cast<const float*>(dy), y,
      static_cast<const float*>(Cm), c, gp, heads, group, S, P, N, chunk,
      ssd::aligned16(Cm, sc_b, sc_h, sc_s), vec_xy);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 pgrid(batch * heads, (N * P + THREADS - 1) / THREADS);
  ssd_bwd_kernel_pass<<<pgrid, THREADS, 0, st>>>(
      gp, static_cast<const float*>(decay),
      static_cast<const float*>(dhfin), nc, N * P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_kernel_scan<<<sgrid, THREADS, SCAN_FLOATS * sizeof(float), st>>>(
      static_cast<const float*>(dta), a, static_cast<const float*>(dtx), x,
      static_cast<const float*>(Bm), b, static_cast<const float*>(Cm), c,
      static_cast<const float*>(dy), y, static_cast<const float*>(states),
      gp, static_cast<const float*>(hfin), static_cast<float*>(ddta), oa,
      static_cast<float*>(ddtx), ox, static_cast<float*>(dB), ob,
      static_cast<float*>(dC), oc, heads, group, S, P, N, chunk, vec_bc,
      vec_xy, vec_st);
  err = cudaGetLastError();
  if (err != cudaSuccess || db_sum == nullptr) return static_cast<int>(err);
  const long long total = batch * per_batch;
  const dim3 hgrid(static_cast<unsigned>((total + THREADS - 1) / THREADS), 2);
  ssd_bwd_kernel_headsum<<<hgrid, THREADS, 0, st>>>(
      static_cast<const float*>(dB), static_cast<const float*>(dC),
      static_cast<float*>(db_sum), static_cast<float*>(dc_sum), groups,
      per_batch, total);
  return static_cast<int>(cudaGetLastError());
}
