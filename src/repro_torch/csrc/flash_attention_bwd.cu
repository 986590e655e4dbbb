// flash_attention_bwd: the gradient of online-softmax attention (dq, dk, dv
// from q, k, v, out, lse and dout), causal or full, with GQA.
//
// Replaces `_flash_bwd_impl` of src/repro/models/attention.py, the custom
// VJP of `_flash_ref`, the XLA twin of the Pallas flash kernel
// (src/repro/kernels/flash_attention/kernel.py) that the JAX model trains
// long sequences through.  That function scans query tiles in order and,
// inside, key tiles, carrying dk and dv across the whole scan; it never
// keeps the [S, S] probabilities: each tile recomputes p = exp(s - lse)
// from the forward's saved log-sum-exp, with D = rowsum(dout * out),
// dv += p^T dout, dp = dout v^T, ds = p (dp - D) scale, dq += ds k and
// dk += ds^T q.  Its conventions hold here: masked scores give p = 0, the
// causal mask is top-left (query position >= key position, as the forward
// kernel's), query head h reads KV head h / (H / Hkv) and the KV gradients
// sum over the group, sums are float32, and the gradients come out in the
// operands' type.  A query offset places query row i at position
// q_offset + i (a context-parallel shard; `_tile_scores`' q_offset): the
// causal mask, (b)'s first query tile and (c)'s last key tile read the
// shifted position, so a shard's dq equals the whole-sequence call's rows
// and the shards' dk and dv add up to the whole one's.
//
// On the card a scan carried across tiles becomes blocks that own their
// output, so that no float atomics are needed and a run is deterministic
// (a resumed training run equals an uninterrupted one bit for bit):
//   (a) flash_bwd_dot_kernel: D = rowsum(dout * out), one warp per row;
//   (b) dk and dv: one block per (batch, KV head, key tile) loops over the
//       group's query heads and the query tiles that see its keys,
//       recomputing s and p, and keeps dk and dv for its keys in registers
//       until it writes them once;
//   (c) dq: one block per (batch, head, query tile) loops over the key
//       tiles its queries see and writes dq once.
// (b) and (c) both recompute s = q k^T and dp = dout v^T: seven products
// in all where the JAX function's scan takes five.
//
// bfloat16 (the training path): flash_bwd_dkdv_wgmma_kernel and
// flash_bwd_dq_wgmma_kernel, shaped after FlashAttention-3's backward on
// the machinery of the forward's flash_kernel_bf16_wgmma (hopper.cuh).  A
// block of 384 threads keeps 128 rows resident (keys in (b), queries in
// (c)): two consumer warpgroups own 64 rows each, and one producer warp,
// its warpgroup's registers lowered with setmaxnreg, streams tiles of 64
// rows of the other side (q and dout in (b), k and v in (c)) by TMA through
// a three-stage ring with mbarriers for full and empty slots.  Every tile
// is two 64-column TMA boxes with the 128-byte swizzle, so d is padded to
// 128 by TMA's out-of-bounds zero fill, as are rows beyond Sq and Sk: any
// d <= 128 that is a multiple of 8 runs one kernel, KS = ceil(d / 16) k16
// steps a template argument, so no product is issued under a run-time
// condition.  (b) computes the transposed scores s^T = k q^T and
// dp^T = v dout^T as wgmma with both operands in shared memory; p^T and
// ds^T are formed in float32 registers and enter dv += p^T dout and
// dk += ds^T q as A fragments from registers, dout and q read transposed
// from shared memory as the forward reads v.  (c) does the same for
// s = q k^T, dp = dout v^T and dq += ds k.  p enters its product rounded
// once to bf16; ds enters as two bf16 terms, ds_hi + ds_lo, two wgmma into
// one float32 accumulator, as the forward splits p: each row of ds sums to
// zero, and with one rounding a row whose query sees few keys lost that
// cancellation (q.grad off by 0.027 at a value of 0.11 on an H100 with
// dout = 2 out).  Each query tile's lse (in the log2 domain) and D reach
// (b) through the ring beside its q and dout, stored by the producer warp;
// (c) reads its rows' own once.  The two consumer warpgroups take turns to
// issue their products (named barriers), so that one forms p and ds while
// the other's run.  Heads lie along the grid's x, so every head's longest
// causal blocks start first.  Above d = 64, dk and dv together with s^T
// and dp^T need more registers than a consumer gets and ptxas serializes
// every wgmma, so (b) runs two passes over its query tiles: dv, then dk,
// s^T recomputed in each.
// float32 (the reduced card-against-CPU checks): flash_bwd_dkdv_kernel and
// flash_bwd_dq_kernel, float32 FMA on the CUDA cores from shared memory,
// 4 x 4 score and 4 x 8 accumulator register tiles a thread, as
// flash_kernel_f32 does.  Operands are read through (batch, head,
// position) strides with unit stride along d <= 128.
//
// What bounds it on an H100: the five products over the unmasked (query,
// key) pairs, 10 B H pairs d operations; at BitNet-1.58B's training shape
// (B = 1, H = Hkv = 16, S = 4096, d = 128, causal) 1.72e11 operations,
// 0.174 ms at the bf16 tensor-core peak (2.56 ms at the float32 CUDA-core
// peak); the bytes (q, k, v, out, dout read, dq, dk, dv written) take 0.04
// ms.  At d = 128 the kernels issue ten product passes (s three times, dp
// twice, dv, dk and dq with ds split in two), 0.35 ms of that peak, and the
// diagonal tiles add a few percent.  Later steps: dq fused into (b) in a
// fixed key-tile order (its s and dp not recomputed), and the float32
// kernels on the tensor cores.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int THREADS = 256;   // 16 x 16
constexpr int BQ = 64;         // query rows of a tile: ty + 16 r, r < 4
constexpr int BK = 64;         // keys of a tile: tx + 16 c, c < 4
constexpr int DMAX = 128;      // accumulator columns tx + 16 c, c < 8

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four [64][d + 1] float tiles, one [BQ][BK + 1] tile of p (then ds) and the
// lse and D of a query tile.
__host__ __device__ inline int smem_floats(int d) {
  return 4 * 64 * (d + 1) + BQ * (BK + 1) + 2 * BQ;
}

// rows [r0, r0 + 64) of one (batch, head) of `src` into dst [64][pd], rows
// at or beyond `rows` as zeros
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int r0,
                                          int rows, int D, int pd) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * pd + c] =
        r0 + r < rows ? src[(r0 + r) * row_stride + c] : 0.0f;
  }
}

// (a) D[b, h, i] = sum_c dout[i][c] out[i][c]
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dot_kernel(const T* __restrict__ o, Strides so,
                     const T* __restrict__ dout, Strides sd,
                     float* __restrict__ dvec, int H, int Sq, int D,
                     long long rows) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;     // whole warps
  const long long bh = row / Sq, i = row % Sq;
  const long long bi = bh / H, hi = bh % H;
  const T* orow = o + bi * so.b + hi * so.h + i * so.s;
  const T* drow = dout + bi * sd.b + hi * sd.h + i * sd.s;
  float acc = 0.0f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(widen(orow[c]), widen(drow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dvec[row] = acc;
}

// s[i][j] = sum_d a[i][d] b[j][d] for the thread's rows i = ty + 16 r and
// columns j = tx + 16 c of two [64][pd] tiles
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* a,
                                         const float* b, int D, int pd,
                                         int tx, int ty) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
  for (int d = 0; d < D; ++d) {
    float bv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = b[(tx + 16 * c) * pd + d];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float av = a[(ty + 16 * r) * pd + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av, bv[c], s[r][c]);
    }
  }
}

// p = exp(s scale - lse) where the (query, key) pair is seen, else 0
__device__ __forceinline__ void probabilities(float (&s)[4][4],
                                              const float* ls, int q0,
                                              int k0, int Sq, int Sk,
                                              float scale, int causal,
                                              int q_offset, int tx, int ty) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qrow = q0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kpos = k0 + tx + 16 * c;
      const bool seen = qrow < Sq && kpos < Sk &&
                        !(causal && q_offset + qrow < kpos);
      s[r][c] = seen ? expf(s[r][c] * scale - ls[ty + 16 * r]) : 0.0f;
    }
  }
}

// acc[r][c] += sum_i w[i][ty + 16 r] x[i][tx + 16 c], w a [64][BK + 1]
// tile read transposed, x a [64][pd] tile
__device__ __forceinline__ void acc_transposed(float (&acc)[4][8],
                                               const float* w,
                                               const float* x, int D,
                                               int pd, int tx, int ty) {
  for (int i = 0; i < 64; ++i) {
    float xv[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = tx + 16 * c;
      xv[c] = col < D ? x[i * pd + col] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float wv = w[i * (BK + 1) + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(wv, xv[c], acc[r][c]);
    }
  }
}

// (b) on the CUDA cores (float32): dk and dv of one 64-key tile of one
// (batch, KV head)
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const float* __restrict__ q, Strides sq,
                      const float* __restrict__ k, Strides sk,
                      const float* __restrict__ v, Strides sv,
                      const float* __restrict__ dout, Strides sdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ dvec, float* __restrict__ dk,
                      Strides sdk, float* __restrict__ dv, Strides sdv, int H,
                      int Hkv, int Sq, int Sk, int D, float scale,
                      int causal, int q_offset) {
  extern __shared__ float smem[];
  const int pd = D + 1;
  float* ks = smem;                  // [BK][pd]
  float* vs = ks + BK * pd;          // [BK][pd]
  float* qs = vs + BK * pd;          // [BQ][pd]
  float* dos = qs + BQ * pd;         // [BQ][pd]
  float* ps = dos + BQ * pd;         // [BQ][BK + 1]: p, then ds
  float* ls = ps + BQ * (BK + 1);    // [BQ] lse
  float* ds = ls + BQ;               // [BQ] D

  const int k0 = blockIdx.x * BK;    // the longest causal loops first
  const long long bi = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int group = H / Hkv;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  load_tile(ks, k + bi * sk.b + hk * sk.h, sk.s, k0, Sk, D, pd);
  load_tile(vs, v + bi * sv.b + hk * sv.h, sv.s, k0, Sk, D, pd);

  float dka[4][8], dva[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) dka[r][c] = dva[r][c] = 0.0f;

  // top-left causal: a query tile ending before position k0 sees none of
  // these keys
  const int qt0 = causal ? max(k0 - q_offset, 0) / BQ : 0;
  const int nqt = (Sq + BQ - 1) / BQ;
  for (int g = 0; g < group; ++g) {
    const long long hi = hk * group + g;
    const float* qh = q + bi * sq.b + hi * sq.h;
    const float* doh = dout + bi * sdo.b + hi * sdo.h;
    const float* lh = lse + (bi * H + hi) * Sq;
    const float* dh = dvec + (bi * H + hi) * Sq;
    for (int qt = qt0; qt < nqt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();               // the previous tile is no longer read
      load_tile(qs, qh, sq.s, q0, Sq, D, pd);
      load_tile(dos, doh, sdo.s, q0, Sq, D, pd);
      if (tid < BQ) {
        ls[tid] = q0 + tid < Sq ? lh[q0 + tid] : 0.0f;
        ds[tid] = q0 + tid < Sq ? dh[q0 + tid] : 0.0f;
      }
      __syncthreads();

      float p[4][4], dp[4][4];
      tile_dot(p, qs, ks, D, pd, tx, ty);
      probabilities(p, ls, q0, k0, Sq, Sk, scale, causal, q_offset, tx, ty);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ps[(ty + 16 * r) * (BK + 1) + tx + 16 * c] = p[r][c];
      tile_dot(dp, dos, vs, D, pd, tx, ty);
      __syncthreads();
      acc_transposed(dva, ps, dos, D, pd, tx, ty);       // dv += p^T dout
      __syncthreads();               // p is no longer read
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ps[(ty + 16 * r) * (BK + 1) + tx + 16 * c] =
              p[r][c] * (dp[r][c] - ds[ty + 16 * r]);
      __syncthreads();
      acc_transposed(dka, ps, qs, D, pd, tx, ty);        // dk += ds^T q
    }
  }

  dk += bi * sdk.b + hk * sdk.h;
  dv += bi * sdv.b + hk * sdv.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = k0 + ty + 16 * r;
    if (row >= Sk) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        dk[row * sdk.s + col] = dka[r][c] * scale;
        dv[row * sdv.s + col] = dva[r][c];
      }
    }
  }
}

// (c) on the CUDA cores (float32): dq of one 64-query tile of one (batch,
// head)
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, Strides sq,
                    const float* __restrict__ k, Strides sk,
                    const float* __restrict__ v, Strides sv,
                    const float* __restrict__ dout, Strides sdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ dvec, float* __restrict__ dq,
                    Strides sdq, int H, int Hkv, int Sq, int Sk, int D,
                    float scale, int causal, int q_offset) {
  extern __shared__ float smem[];
  const int pd = D + 1;
  float* qs = smem;                  // [BQ][pd]
  float* dos = qs + BQ * pd;         // [BQ][pd]
  float* ks = dos + BQ * pd;         // [BK][pd]
  float* vs = ks + BK * pd;          // [BK][pd]
  float* ps = vs + BK * pd;          // [BQ][BK + 1]: ds
  float* ls = ps + BQ * (BK + 1);    // [BQ] lse
  float* ds = ls + BQ;               // [BQ] D

  const int nqt = (Sq + BQ - 1) / BQ;
  const int q0 = (nqt - 1 - blockIdx.x) * BQ;   // longest causal rows first
  const long long bi = blockIdx.y / H, hi = blockIdx.y % H;
  const long long hk = hi / (H / Hkv);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  load_tile(qs, q + bi * sq.b + hi * sq.h, sq.s, q0, Sq, D, pd);
  load_tile(dos, dout + bi * sdo.b + hi * sdo.h, sdo.s, q0, Sq, D, pd);
  if (tid < BQ) {
    const long long at = (bi * H + hi) * Sq + q0 + tid;
    ls[tid] = q0 + tid < Sq ? lse[at] : 0.0f;
    ds[tid] = q0 + tid < Sq ? dvec[at] : 0.0f;
  }
  const float* kh = k + bi * sk.b + hk * sk.h;
  const float* vh = v + bi * sv.b + hk * sv.h;

  int nkt = (Sk + BK - 1) / BK;
  if (causal) nkt = min(nkt, (q_offset + min(q0 + BQ, Sq) - 1) / BK + 1);

  float dqa[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) dqa[r][c] = 0.0f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                 // the previous tile is no longer read
    load_tile(ks, kh, sk.s, k0, Sk, D, pd);
    load_tile(vs, vh, sv.s, k0, Sk, D, pd);
    __syncthreads();

    float p[4][4], dp[4][4];
    tile_dot(p, qs, ks, D, pd, tx, ty);
    probabilities(p, ls, q0, k0, Sq, Sk, scale, causal, q_offset, tx, ty);
    tile_dot(dp, dos, vs, D, pd, tx, ty);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ps[(ty + 16 * r) * (BK + 1) + tx + 16 * c] =
            p[r][c] * (dp[r][c] - ds[ty + 16 * r]);
    __syncthreads();
    // dq[i][c] += sum_j ds[i][j] k[j][c]
    for (int j = 0; j < BK; ++j) {
      float kv[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = tx + 16 * c;
        kv[c] = col < D ? ks[j * pd + col] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float w = ps[(ty + 16 * r) * (BK + 1) + j];
#pragma unroll
        for (int c = 0; c < 8; ++c) dqa[r][c] = fmaf(w, kv[c], dqa[r][c]);
      }
    }
  }

  dq += bi * sdq.b + hi * sdq.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= Sq) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = tx + 16 * c;
      if (col < D) dq[row * sdq.s + col] = dqa[r][c] * scale;
    }
  }
}

// ------------------------------------------------------------------------- //
// bfloat16: TMA + wgmma
// ------------------------------------------------------------------------- //

typedef __nv_bfloat16 bf16;

constexpr int G_ROWS = 64;                 // rows of a tile and of a warpgroup
constexpr int G_CONSUMERS = 2;             // consumer warpgroups of a block
constexpr int G_BLOCK = G_ROWS * G_CONSUMERS;   // resident rows of a block
constexpr int G_THREADS = 128 * (G_CONSUMERS + 1);
constexpr int G_BOX_BYTES = G_ROWS * BOX_COLS * 2;   // [64 rows][64] bf16
constexpr int G_TILE_BYTES = 2 * G_BOX_BYTES;        // d padded to 128
constexpr int G_STAGES = 3;
constexpr int G_STATS = 2 * G_ROWS;        // a query tile's lse and D
constexpr int G_RING_BYTES = G_TILE_BYTES * 2 * (G_CONSUMERS + G_STAGES);
constexpr int G_SMEM_BYTES = 1024 + G_RING_BYTES + G_STATS * 4 * G_STAGES;
constexpr float LOG2E = 1.4426950408889634f;

// the output columns of a product over d split at the TMA box
__host__ __device__ constexpr int n1(int ks) { return ks < 4 ? 16 * ks : 64; }
__host__ __device__ constexpr int n2(int ks) { return 16 * ks - n1(ks); }
__host__ __device__ constexpr int n2_regs(int ks) {
  return n2(ks) > 0 ? n2(ks) / 2 : 1;
}

// Shared addresses of the tiles: the resident pair x and y (k and v in
// (b), q and dout in (c)), 64 rows a consumer warpgroup, then the ring's
// streamed pairs u and w (q and dout in (b), k and v in (c)); each tile
// two boxes of 64 columns.
struct Tiles {
  uint32_t base;
  __device__ uint32_t x(int wg) const { return base + G_TILE_BYTES * wg; }
  __device__ uint32_t y(int wg) const {
    return base + G_TILE_BYTES * (G_CONSUMERS + wg);
  }
  __device__ uint32_t u(int st) const {
    return base + G_TILE_BYTES * (2 * G_CONSUMERS + st);
  }
  __device__ uint32_t w(int st) const {
    return base + G_TILE_BYTES * (2 * G_CONSUMERS + G_STAGES + st);
  }
};

// d = A B^T over the head dimension in KS k16 steps: A the warpgroup's 64
// resident rows, B a streamed tile of 64 rows, both K-major; d is the
// m64n64 float32 fragment.
template <int KS>
__device__ __forceinline__ void ss_scores(float (&d)[32], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint32_t off = (ks / 4) * G_BOX_BYTES + (ks % 4) * 32;
    wgmma_ss_n64(d, smem_desc(a + off, 16, 1024),
                 smem_desc(b + off, 16, 1024), ks > 0);
  }
}

// acc += w x over a streamed tile's 64 rows: w [64 x 64] float32 in the
// m64n64 accumulator layout (thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4) (+ 1) in
// w[4 j .. 4 j + 3]) enters as bf16 A fragments from registers: each pair
// of neighbouring columns packs into one register, and registers
// 4 kk .. 4 kk + 3 are the m64k16 fragment of step kk.  With SPLIT, w
// enters as two bf16 terms, w = w_hi + w_lo, two products into the one
// accumulator (~2^-17 relative).  x is read transposed, its columns split
// at the TMA box into acc0 (n1) and acc1 (n2).
template <int KS, bool SPLIT>
__device__ __forceinline__ void rs_product(float (&acc0)[n1(KS) / 2],
                                           float (&acc1)[n2_regs(KS)],
                                           const float (&w)[32], uint32_t x) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = w[8 * kk + 2 * i], b = w[8 * kk + 2 * i + 1];
      hi[i] = bf16x2_bits(a, b);
      if constexpr (SPLIT) {
        const __nv_bfloat162 h =
            *reinterpret_cast<const __nv_bfloat162*>(&hi[i]);
        lo[i] = bf16x2_bits(a - __low2float(h), b - __high2float(h));
      }
    }
    const uint32_t rows = x + kk * 16 * 128;
    const uint64_t d0 = smem_desc(rows, 1024, 1024);
    wgmma_rs(acc0, hi[0], hi[1], hi[2], hi[3], d0);
    if constexpr (SPLIT) wgmma_rs(acc0, lo[0], lo[1], lo[2], lo[3], d0);
    if constexpr (n2(KS) > 0) {
      const uint64_t d1 = smem_desc(rows + G_BOX_BYTES, 1024, 1024);
      wgmma_rs(acc1, hi[0], hi[1], hi[2], hi[3], d1);
      if constexpr (SPLIT) wgmma_rs(acc1, lo[0], lo[1], lo[2], lo[3], d1);
    }
  }
}

// The two consumer warpgroups take turns to issue their products (named
// barriers 1 and 2 of 256 threads: one warpgroup waits at its own, the
// other arrives), so that one forms p and ds while the other's products
// run; in step, both formed them at once and left the tensor cores idle
// (4-5 % slower on an H100).  Warpgroup 1 lets 0 go first, and 0 takes
// that extra arrival back at the end.
__device__ __forceinline__ void turn_begin(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_end(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}
__device__ __forceinline__ void turns_start(int wg) {
  if (wg == 1) turn_end(wg);
}
__device__ __forceinline__ void turns_done(int wg) {
  if (wg == 0) turn_begin(wg);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.0f;
}

// rows row0 and row0 + 8 of a warpgroup's m64n(16 KS) accumulator, times
// mul, to bf16 rows of dst below `rows`, columns below D
template <int KS>
__device__ __forceinline__ void store_rows(bf16* dst, long long row_stride,
                                           const float (&acc0)[n1(KS) / 2],
                                           const float (&acc1)[n2_regs(KS)],
                                           float mul, int row0, int rows,
                                           int D, int col0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= rows) continue;
    bf16* out = dst + static_cast<long long>(row) * row_stride;
#pragma unroll
    for (int j = 0; j < n1(KS) / 8; ++j) {
      const int col = 8 * j + col0;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(
            acc0[4 * j + 2 * h] * mul, acc0[4 * j + 2 * h + 1] * mul);
    }
#pragma unroll
    for (int j = 0; j < n2(KS) / 8; ++j) {
      const int col = BOX_COLS + 8 * j + col0;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(
            acc1[4 * j + 2 * h] * mul, acc1[4 * j + 2 * h + 1] * mul);
    }
  }
}

__device__ __forceinline__ void init_ring(uint64_t (&bars)[1 + 2 * G_STAGES],
                                          int full_count) {
  mbar_init(smem_u32(&bars[0]), 1);
  for (int st = 0; st < G_STAGES; ++st) {
    mbar_init(smem_u32(&bars[1 + st]), full_count);
    mbar_init(smem_u32(&bars[1 + G_STAGES + st]), 4 * G_CONSUMERS);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The resident pair: rows r0.. of (head, batch) from maps mx and my, 64 a
// consumer warpgroup, onto barrier bar.
template <int KS>
__device__ __forceinline__ void load_resident(const Tiles& t,
                                              const CUtensorMap* mx,
                                              const CUtensorMap* my,
                                              uint32_t bar, int r0, int head,
                                              int batch) {
  constexpr int boxes = KS > 4 ? 2 : 1;
  mbar_expect_tx(bar, 2 * G_CONSUMERS * boxes * G_BOX_BYTES);
  for (int r = 0; r < G_CONSUMERS; ++r)
    for (int bx = 0; bx < boxes; ++bx) {
      tma_load(t.x(r) + bx * G_BOX_BYTES, mx, bar, bx * BOX_COLS,
               r0 + r * G_ROWS, head, batch);
      tma_load(t.y(r) + bx * G_BOX_BYTES, my, bar, bx * BOX_COLS,
               r0 + r * G_ROWS, head, batch);
    }
}

// One streamed pair into stage st: 64 rows from r0 of maps mu and mw.
template <int KS>
__device__ __forceinline__ void load_stage(const Tiles& t, int st,
                                           const CUtensorMap* mu,
                                           const CUtensorMap* mw,
                                           uint32_t bar, int r0, int head,
                                           int batch) {
  constexpr int boxes = KS > 4 ? 2 : 1;
  mbar_expect_tx(bar, 2 * boxes * G_BOX_BYTES);
  for (int bx = 0; bx < boxes; ++bx) {
    tma_load(t.u(st) + bx * G_BOX_BYTES, mu, bar, bx * BOX_COLS, r0, head,
             batch);
    tma_load(t.w(st) + bx * G_BOX_BYTES, mw, bar, bx * BOX_COLS, r0, head,
             batch);
  }
}

// One pass of (b)'s consumer loop over the block's query tiles, its ring
// slots counted from `first`: dv += p^T dout with DV and dk += ds^T q with
// DK, s^T = k q^T recomputed in each pass, then the pass's gradients
// stored.  The warpgroup's 64 keys start at kw; its thread holds the rows
// key0 and key0 + 8 and the columns col0 (+ 1) + 8 j of an m64n64 tile.
// The loop reads kw and key0 less the query offset (kw_q, key_q), which a
// query row is compared with as it stands, so that the offset holds no
// register of its own in the loop.
template <int KS, bool DV, bool DK>
__device__ __forceinline__ void dkdv_pass(
    const Tiles& t, const uint64_t* bars, const float* stats, int first,
    const int& tiles, const int& per_head, const int& qt0, int wg, int kw_q,
    int key_q, int col0, int lane, int Sq, int Sk, int D, float scale,
    float scale_log2, int causal, int q_offset, bf16* dk, long long sdk,
    bf16* dv, long long sdv) {
  float dk0[n1(KS) / 2], dk1[n2_regs(KS)], dv0[n1(KS) / 2],
      dv1[n2_regs(KS)];
  zero(dk0);
  zero(dk1);
  zero(dv0);
  zero(dv1);
  for (int i = 0; i < tiles; ++i) {
    const int it = first + i, st = it % G_STAGES, fill = it / G_STAGES;
    const int q0 = (qt0 + i % per_head) * G_ROWS;
    mbar_wait(smem_u32(&bars[1 + st]), fill & 1);

    // s^T = k q^T, dp^T = v dout^T
    float s[32], dp[32];
    zero(s);
    zero(dp);
    turn_begin(wg);
    wgmma_fence();
    ss_scores<KS>(s, t.x(wg), t.u(st));
    if constexpr (DK) ss_scores<KS>(dp, t.y(wg), t.w(st));
    wgmma_commit();
    turn_end(wg);
    wgmma_wait_all();
    fence_regs(s);
    if constexpr (DK) fence_regs(dp);

    // p^T = 2^(s^T scale log2(e) - lse log2(e)), 0 where a query's
    // position precedes a key (causal) or it lies beyond Sq (only diagonal
    // and ragged tiles are masked), and ds^T = p^T (dp^T - D), in place
    const float* ls = stats + st * G_STATS;
    const bool masked =
        q0 + G_ROWS > Sq || (causal && q0 < kw_q + G_ROWS - 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(ls + 8 * j + col0);
      const float2 dd =
          *reinterpret_cast<const float2*>(ls + G_ROWS + 8 * j + col0);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          float p = ex2(fmaf(s[i], scale_log2, -(e ? l.y : l.x)));
          if (masked) {
            const int query = q0 + 8 * j + col0 + e;
            if (query >= Sq || (causal && query < key_q + 8 * h)) p = 0.0f;
          }
          s[i] = p;
          if constexpr (DK) dp[i] = p * (dp[i] - (e ? dd.y : dd.x));
        }
    }
    // dv += p^T dout, dk += ds^T q
    turn_begin(wg);
    wgmma_fence();
    if constexpr (DV) rs_product<KS, false>(dv0, dv1, s, t.w(st));
    if constexpr (DK) rs_product<KS, true>(dk0, dk1, dp, t.u(st));
    wgmma_commit();
    turn_end(wg);
    wgmma_wait_all();
    if constexpr (DV) {
      fence_regs(dv0);
      fence_regs(dv1);
    }
    if constexpr (DK) {
      fence_regs(dk0);
      fence_regs(dk1);
    }
    if (lane == 0) mbar_arrive(smem_u32(&bars[1 + G_STAGES + st]));
  }
  if constexpr (DK)
    store_rows<KS>(dk, sdk, dk0, dk1, scale, key_q + q_offset, Sk, D, col0);
  if constexpr (DV)
    store_rows<KS>(dv, sdv, dv0, dv1, 1.0f, key_q + q_offset, Sk, D, col0);
}

// (b) dk and dv of 128 keys of one (batch, KV head), 64 a consumer
// warpgroup, over the query tiles of the group's heads that see them: one
// pass at d <= 64; above, a pass for dv and one for dk (at d = 128 their
// 128 float32 accumulators a thread with s^T and dp^T made ptxas
// serialize every wgmma), the producer streaming the tiles twice.
template <int KS>
__global__ void __launch_bounds__(G_THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ dvec,
                            bf16* __restrict__ dk, Strides sdk,
                            bf16* __restrict__ dv, Strides sdv, int H,
                            int Hkv, int Sq, int Sk, int D, float scale,
                            float scale_log2, int causal, int q_offset) {
  constexpr int passes = KS > 4 ? 2 : 1;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * G_STAGES];
  // loop bounds in shared memory, read once per tile: at d = 128 registers
  // held across the loop would spill
  __shared__ int tiles, per_head, qt0;
  const uint32_t raw = smem_u32(smem_raw);
  const Tiles t{(raw + 1023u) & ~1023u};
  // [stage][lse in the log2 domain (64), D (64)]
  float* stats = reinterpret_cast<float*>(smem_raw + (t.base - raw) +
                                          G_RING_BYTES);
  const uint32_t resident = smem_u32(&bars[0]);

  // heads along x, so that the grid's first blocks are every head's
  // longest causal loops
  const int k0 = blockIdx.y * G_BLOCK;
  const int bi = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int group = H / Hkv;
  if (threadIdx.x == 0) {
    // top-left causal: a query tile ending before position k0 sees none of
    // its keys
    const int first = causal ? max(k0 - q_offset, 0) / G_ROWS : 0;
    const int n = max((Sq + G_ROWS - 1) / G_ROWS - first, 0);
    qt0 = first;
    per_head = n;
    tiles = group * n;
    // a full slot: the TMA bytes and the producer warp's 32 stat stores
    init_ring(bars, 1 + 32);
  }
  __syncthreads();

  // warp-uniform to the compiler, so that each role's register budget
  // follows its setmaxnreg
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == G_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x < 128 * G_CONSUMERS + 32) {   // one producer warp
      const int lane = threadIdx.x % 32;
      if (lane == 0) load_resident<KS>(t, &tk, &tv, resident, k0, hk, bi);
      for (int it = 0; it < passes * tiles; ++it) {
        const int st = it % G_STAGES, fill = it / G_STAGES;
        const int i = it % tiles;
        const int hi = hk * group + i / per_head;
        const int q0 = (qt0 + i % per_head) * G_ROWS;
        if (fill > 0)
          mbar_wait(smem_u32(&bars[1 + G_STAGES + st]), (fill - 1) & 1);
        const uint32_t full = smem_u32(&bars[1 + st]);
        if (lane == 0) load_stage<KS>(t, st, &tq, &tdo, full, q0, hi, bi);
        float* ls = stats + st * G_STATS;
        const long long at = (static_cast<long long>(bi) * H + hi) * Sq + q0;
        for (int r = lane; r < G_ROWS; r += 32) {
          const bool in = q0 + r < Sq;
          ls[r] = in ? lse[at + r] * LOG2E : 0.0f;
          ls[G_ROWS + r] = in ? dvec[at + r] : 0.0f;
        }
        mbar_arrive(full);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wt = threadIdx.x % 128, warp = wt / 32, lane = wt % 32;
    const int kw = k0 + G_ROWS * wg;                 // the warpgroup's keys
    const int key0 = kw + 16 * warp + lane / 4;
    const int kw_q = kw - q_offset, key_q = key0 - q_offset;
    const int col0 = 2 * (lane % 4);
    bf16* dkb = dk + bi * sdk.b + hk * sdk.h;
    bf16* dvb = dv + bi * sdv.b + hk * sdv.h;
    mbar_wait(resident, 0);
    turns_start(wg);
    if constexpr (passes == 1) {
      dkdv_pass<KS, true, true>(t, bars, stats, 0, tiles, per_head, qt0, wg,
                                kw_q, key_q, col0, lane, Sq, Sk, D, scale,
                                scale_log2, causal, q_offset, dkb, sdk.s,
                                dvb, sdv.s);
    } else {
      dkdv_pass<KS, true, false>(t, bars, stats, 0, tiles, per_head, qt0,
                                 wg, kw_q, key_q, col0, lane, Sq, Sk, D,
                                 scale, scale_log2, causal, q_offset, dkb,
                                 sdk.s, dvb, sdv.s);
      dkdv_pass<KS, false, true>(t, bars, stats, tiles, tiles, per_head, qt0,
                                 wg, kw_q, key_q, col0, lane, Sq, Sk, D,
                                 scale, scale_log2, causal, q_offset, dkb,
                                 sdk.s, dvb, sdv.s);
    }
    turns_done(wg);
  }
}

// (c) dq of 128 queries of one (batch, head), 64 a consumer warpgroup, over
// the key tiles they see
template <int KS>
__global__ void __launch_bounds__(G_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ dvec,
                          bf16* __restrict__ dq, Strides sdq, int H, int Hkv,
                          int Sq, int Sk, int D, float scale,
                          float scale_log2, int causal, int q_offset) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * G_STAGES];
  __shared__ int tiles;
  const Tiles t{(smem_u32(smem_raw) + 1023u) & ~1023u};
  const uint32_t resident = smem_u32(&bars[0]);
  auto full = [&](int st) { return smem_u32(&bars[1 + st]); };
  auto empty = [&](int st) { return smem_u32(&bars[1 + G_STAGES + st]); };

  // heads along x: every head's longest causal rows first
  const int nqb = (Sq + G_BLOCK - 1) / G_BLOCK;
  const int q0 = (nqb - 1 - blockIdx.y) * G_BLOCK;
  const int bi = blockIdx.x / H, hi = blockIdx.x % H, hk = hi / (H / Hkv);
  if (threadIdx.x == 0) {
    int n = (Sk + G_ROWS - 1) / G_ROWS;
    if (causal)
      n = min(n, (q_offset + min(q0 + G_BLOCK, Sq) - 1) / G_ROWS + 1);
    tiles = n;
    init_ring(bars, 1);
  }
  __syncthreads();

  // warp-uniform to the compiler, so that each role's register budget
  // follows its setmaxnreg
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == G_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * G_CONSUMERS) {   // one producer thread
      load_resident<KS>(t, &tq, &tdo, resident, q0, hi, bi);
      for (int kt = 0; kt < tiles; ++kt) {
        const int st = kt % G_STAGES, fill = kt / G_STAGES;
        if (fill > 0) mbar_wait(empty(st), (fill - 1) & 1);
        load_stage<KS>(t, st, &tk, &tv, full(st), kt * G_ROWS, hk, bi);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wt = threadIdx.x % 128, warp = wt / 32, lane = wt % 32;
    const int qw = q0 + G_ROWS * wg;                 // the warpgroup's rows
    const int row0 = qw + 16 * warp + lane / 4;      // and row0 + 8
    const int col0 = 2 * (lane % 4);
    // the rows' lse in the log2 domain and D
    float l2[2], dr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      const long long at = (static_cast<long long>(bi) * H + hi) * Sq + row;
      l2[h] = row < Sq ? lse[at] * LOG2E : 0.0f;
      dr[h] = row < Sq ? dvec[at] : 0.0f;
    }
    // the loop reads the rows' query positions in place of the rows, so
    // that the offset holds no register of its own in it (as dkdv_pass)
    const int pos_w = q_offset + qw, pos0 = q_offset + row0;
    float dq0[n1(KS) / 2], dq1[n2_regs(KS)];
    zero(dq0);
    zero(dq1);

    mbar_wait(resident, 0);
    turns_start(wg);
    for (int kt = 0; kt < tiles; ++kt) {
      const int st = kt % G_STAGES, fill = kt / G_STAGES;
      const int k0 = kt * G_ROWS;
      mbar_wait(full(st), fill & 1);

      // s = q k^T, dp = dout v^T
      float s[32], dp[32];
      zero(s);
      zero(dp);
      turn_begin(wg);
      wgmma_fence();
      ss_scores<KS>(s, t.x(wg), t.u(st));
      ss_scores<KS>(dp, t.y(wg), t.w(st));
      wgmma_commit();
      turn_end(wg);
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // ds = p (dp - D), p = 0 where a key follows the query's position
      // (causal) or lies beyond Sk: only diagonal and ragged tiles are
      // masked
      const bool masked =
          k0 + G_ROWS > Sk || (causal && k0 + G_ROWS - 1 > pos_w);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            float p = ex2(fmaf(s[i], scale_log2, -l2[h]));
            if (masked) {
              const int key = k0 + 8 * j + col0 + e;
              if (key >= Sk || (causal && pos0 + 8 * h < key)) p = 0.0f;
            }
            dp[i] = p * (dp[i] - dr[h]);
          }
      // dq += ds k
      turn_begin(wg);
      wgmma_fence();
      rs_product<KS, true>(dq0, dq1, dp, t.u(st));
      wgmma_commit();
      turn_end(wg);
      wgmma_wait_all();
      fence_regs(dq0);
      fence_regs(dq1);
      if (lane == 0) mbar_arrive(empty(st));
    }
    turns_done(wg);
    store_rows<KS>(dq + bi * sdq.b + hi * sdq.h, sdq.s, dq0, dq1, scale,
                   pos0 - q_offset, Sq, D, col0);
  }
}

struct Operands {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
};

// (a), on either type
template <typename T>
int launch_dot(const Operands& a, float* dvec, int B, int H, int Sq, int D,
               cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * H * Sq;
  const long long blocks = (rows * 32 + THREADS - 1) / THREADS;
  flash_bwd_dot_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0,
                            stream>>>(static_cast<const T*>(a.o), a.so,
                                      static_cast<const T*>(a.dout), a.sdo,
                                      dvec, H, Sq, D, rows);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const Operands& a, const float* lse, float* dvec, int B, int H,
               int Hkv, int Sq, int Sk, int D, float scale, int causal,
               int q_offset, cudaStream_t stream) {
  const int bytes = smem_floats(D) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = launch_dot<float>(a, dvec, B, H, Sq, D, stream);
  if (rc != 0) return rc;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  flash_bwd_dkdv_kernel
      <<<dim3((Sk + BK - 1) / BK, B * Hkv), THREADS, bytes, stream>>>(
          q, a.sq, k, a.sk, v, a.sv, dout, a.sdo, lse, dvec,
          static_cast<float*>(a.dk), a.sdk, static_cast<float*>(a.dv), a.sdv,
          H, Hkv, Sq, Sk, D, scale, causal, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel
      <<<dim3((Sq + BQ - 1) / BQ, B * H), THREADS, bytes, stream>>>(
          q, a.sq, k, a.sk, v, a.sv, dout, a.sdo, lse, dvec,
          static_cast<float*>(a.dq), a.sdq, H, Hkv, Sq, Sk, D, scale, causal,
          q_offset);
  return static_cast<int>(cudaGetLastError());
}


template <int KS>
int launch_wgmma(const Operands& a, const CUtensorMap (&maps)[4],
                 const float* lse, const float* dvec, int B, int H, int Hkv,
                 int Sq, int Sk, int D, float scale, int causal, int q_offset,
                 cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma_kernel<KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<KS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = scale * LOG2E;
  flash_bwd_dkdv_wgmma_kernel<KS>
      <<<dim3(B * Hkv, (Sk + G_BLOCK - 1) / G_BLOCK), G_THREADS,
         G_SMEM_BYTES, stream>>>(
          maps[0], maps[1], maps[2], maps[3], lse, dvec,
          static_cast<bf16*>(a.dk), a.sdk, static_cast<bf16*>(a.dv), a.sdv,
          H, Hkv, Sq, Sk, D, scale, scale_log2, causal, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_wgmma_kernel<KS>
      <<<dim3(B * H, (Sq + G_BLOCK - 1) / G_BLOCK), G_THREADS, G_SMEM_BYTES,
         stream>>>(maps[0], maps[1], maps[2], maps[3], lse, dvec,
                   static_cast<bf16*>(a.dq), a.sdq, H, Hkv, Sq, Sk, D, scale,
                   scale_log2, causal, q_offset);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const Operands& a, const float* lse, float* dvec, int B,
                int H, int Hkv, int Sq, int Sk, int D, float scale,
                int causal, int q_offset, cudaStream_t stream) {
  // what TMA takes: 16-byte aligned bases and byte strides, d % 8 == 0
  // (ops.tma_layout_error); 64-row boxes over q, k, v and dout
  CUtensorMap maps[4];
  if (D % 8 != 0 ||
      !encode_map(&maps[0], a.q, a.sq, D, Sq, H, B, G_ROWS) ||
      !encode_map(&maps[1], a.k, a.sk, D, Sk, Hkv, B, G_ROWS) ||
      !encode_map(&maps[2], a.v, a.sv, D, Sk, Hkv, B, G_ROWS) ||
      !encode_map(&maps[3], a.dout, a.sdo, D, Sq, H, B, G_ROWS))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = launch_dot<bf16>(a, dvec, B, H, Sq, D, stream);
  if (rc != 0) return rc;
  static int (*const by_width[8])(const Operands&, const CUtensorMap (&)[4],
                                   const float*, const float*, int, int, int,
                                   int, int, int, float, int, int,
                                   cudaStream_t) = {
      launch_wgmma<1>, launch_wgmma<2>, launch_wgmma<3>, launch_wgmma<4>,
      launch_wgmma<5>, launch_wgmma<6>, launch_wgmma<7>, launch_wgmma<8>};
  return by_width[(D + 15) / 16 - 1](a, maps, lse, dvec, B, H, Hkv, Sq, Sk,
                                     D, scale, causal, q_offset, stream);
}

}  // namespace

// Launches the three kernels on `stream`; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a call they do not take.
// dtype 0: float32 operands and gradients, 1: bfloat16.  q, out, dout and dq
// are indexed [batch, head, position, d], k, v, dk and dv [batch, kv head,
// position, d], each through the three strides given for it (in elements),
// d with unit stride.  `lse` is the forward's float32 [B, H, Sq] log-sum-exp
// (contiguous); `dvec` float32 [B, H, Sq] scratch that receives D.
// `q_offset` >= 0 is the position of query row 0, as the forward takes it,
// and comes last for the same reason.
extern "C" int flash_attention_bwd_launch(
    int dtype, const void* q, long long sq_b, long long sq_h, long long sq_s,
    const void* k, long long sk_b, long long sk_h, long long sk_s,
    const void* v, long long sv_b, long long sv_h, long long sv_s,
    const void* o, long long so_b, long long so_h, long long so_s,
    const void* dout, long long sd_b, long long sd_h, long long sd_s,
    void* dq, long long sdq_b, long long sdq_h, long long sdq_s, void* dk,
    long long sdk_b, long long sdk_h, long long sdk_s, void* dv,
    long long sdv_b, long long sdv_h, long long sdv_s, const void* lse,
    void* dvec, int B, int H, int Hkv, int Sq, int Sk, int D, float scale,
    int causal, void* stream, int q_offset) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Sk < 1 ||
      D < 1 || D > DMAX || B * H > 65535 || q_offset < 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Operands a{q,
                   k,
                   v,
                   o,
                   dout,
                   dq,
                   dk,
                   dv,
                   {sq_b, sq_h, sq_s},
                   {sk_b, sk_h, sk_s},
                   {sv_b, sv_h, sv_s},
                   {so_b, so_h, so_s},
                   {sd_b, sd_h, sd_s},
                   {sdq_b, sdq_h, sdq_s},
                   {sdk_b, sdk_h, sdk_s},
                   {sdv_b, sdv_h, sdv_s}};
  const float* l = static_cast<const float*>(lse);
  float* rowdot = static_cast<float*>(dvec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(a, l, rowdot, B, H, Hkv, Sq, Sk, D, scale, causal,
                      q_offset, s);
  return launch_bf16(a, l, rowdot, B, H, Hkv, Sq, Sk, D, scale, causal,
                     q_offset, s);
}
