// block_sparse: C[M, N] (+)= A[M, K] @ B[K, N] over the non-zero blocks of a
// CSR-of-blocks schedule (the paper's zero-tile book, ZTB).
//
// Replaces the TPU kernel `_block_sparse_kernel` / `block_sparse_matmul` of
// src/repro/kernels/block_sparse/kernel.py.  That Pallas kernel walks a grid
// (M tile, N-tile column j, step s) whose third axis runs in order and carries
// an f32 VMEM accumulator; scalar prefetch brings the schedule
// (`idx[j, :cnt[j]]`, the non-zero K blocks of column j) so that the
// BlockSpec index maps DMA only non-zero blocks.  Here blocks run in parallel
// and in no order, so:
//
//   - one thread block per (M tile, N sub-tile of column j) runs the loop
//     `for s < cnt[j]` itself, reading idx[j, s] from global memory (the
//     analogue of scalar prefetch), and keeps the sum in registers;
//   - it stages only that x column block and that w block through shared
//     memory: a zero block is never loaded, a column with cnt[j] == 0 loads
//     nothing (it writes zeros, or leaves C untouched when accumulating).
//
// Operand types: int8 x int8 -> int32, exact (__dp4a over K-contiguous words,
// as in bitlinear.cu), and f32 x f32 -> f32 by FMA in schedule order.
// Schedule blocks are bk x bn; the last block row and column may be ragged,
// and M, N and K edges are masked with zeros.  Leading-dimension strides are
// passed in (unit stride along the last axis), so strided views of larger
// matrices go in uncopied.
//
// What bounds it on an H100: the work is the non-zero blocks only.  For the
// attention projections at prefill (M = 512 rows, K = 2560) an int8 block is
// reused by every row, so the int8 tensor-core rate is the ceiling (about
// 0.2 us for the densest qkv slice) while reading the non-zero blocks and x
// once takes under a microsecond at 3.35 TB/s; at M = 16 (a MoE step) the
// bytes bound.  This first version multiplies on the CUDA cores (__dp4a /
// FMA) and restages x per N sub-tile, so it stays far above both; to keep
// the SMs busy at small M x N the int path may split the schedule entries
// of a column over gridDim.z blocks that add with integer atomics (exact in
// any order).  wgmma, TMA and pipelining are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 64;                   // output columns per block
constexpr int THREADS = 256;             // 16 x 16: 4 columns x RM rows each
constexpr int KC8 = 128;                 // int8 K values staged per step
constexpr int PITCH8 = KC8 + 4;          // bytes per smem row: 33 words
constexpr int WPITCH8 = PITCH8 / 4;
constexpr int KCF = 32;                  // f32 K values staged per step
constexpr int PITCHF = KCF + 1;

struct Tile {
  int j, n0, n1, m0;                     // schedule column, columns [n0, n1), first row
};

__device__ __forceinline__ Tile tile_of(int N, int bn, int subtiles, int bm) {
  Tile t;
  t.j = blockIdx.x / subtiles;
  const int part = blockIdx.x % subtiles;
  t.n0 = t.j * bn + part * TN;
  t.n1 = min(min(t.n0 + TN, (t.j + 1) * bn), N);
  t.m0 = blockIdx.y * bm;
  return t;
}

template <int RM>
__global__ void __launch_bounds__(THREADS)
block_sparse_i8_kernel(const int8_t* __restrict__ A, long long lda,
                       const int8_t* __restrict__ B, long long ldb,
                       int32_t* __restrict__ C, long long ldc, int M, int N,
                       int K, const int* __restrict__ idx, int S,
                       const int* __restrict__ cnt, int bk, int bn,
                       int subtiles, int accumulate, int per_split) {
  constexpr int BM = 16 * RM;
  __shared__ __align__(16) int8_t xs[BM * PITCH8];
  __shared__ __align__(16) int8_t ws[TN * PITCH8];   // [n][k], K-contiguous

  const Tile t = tile_of(N, bn, subtiles, BM);
  if (t.n0 >= t.n1) return;
  const int tid = threadIdx.x;
  const int tx = tid % 16;               // columns n0 + tx + 16 c
  const int ty = tid / 16;               // rows m0 + ty + 16 r
  const int count = cnt[t.j];
  const int s0 = blockIdx.z * per_split;
  const int s1 = min(s0 + per_split, count);
  if (accumulate && s0 >= s1) return;    // nothing to add

  int acc[RM][4] = {};
  const int* xw = reinterpret_cast<const int*>(xs);
  const int* ww = reinterpret_cast<const int*>(ws);

  for (int s = s0; s < s1; ++s) {
    const int k_lo = idx[t.j * S + s] * bk;
    const int k_hi = min(k_lo + bk, K);
    for (int k0 = k_lo; k0 < k_hi; k0 += KC8) {
      for (int i = tid; i < BM * KC8; i += THREADS) {
        const int r = i / KC8, c = i % KC8;
        const int m = t.m0 + r, k = k0 + c;
        xs[r * PITCH8 + c] = (m < M && k < k_hi) ? A[m * lda + k] : int8_t(0);
      }
      for (int i = tid; i < KC8 * TN; i += THREADS) {
        const int r = i / TN, c = i % TN;
        const int n = t.n0 + c, k = k0 + r;
        ws[c * PITCH8 + r] = (n < t.n1 && k < k_hi) ? B[k * ldb + n] : int8_t(0);
      }
      __syncthreads();
#pragma unroll 4
      for (int kw = 0; kw < KC8 / 4; ++kw) {
        int b[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = ww[(tx + 16 * c) * WPITCH8 + kw];
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const int a = xw[(ty + 16 * r) * WPITCH8 + kw];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = __dp4a(a, b[c], acc[r][c]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int m = t.m0 + ty + 16 * r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = t.n0 + tx + 16 * c;
      if (n >= t.n1) continue;
      int32_t* dst = C + m * ldc + n;
      if (!accumulate) {
        *dst = acc[r][c];
      } else if (gridDim.z > 1) {
        atomicAdd(dst, acc[r][c]);
      } else {
        *dst += acc[r][c];
      }
    }
  }
}

template <int RM>
__global__ void __launch_bounds__(THREADS)
block_sparse_f32_kernel(const float* __restrict__ A, long long lda,
                        const float* __restrict__ B, long long ldb,
                        float* __restrict__ C, long long ldc, int M, int N,
                        int K, const int* __restrict__ idx, int S,
                        const int* __restrict__ cnt, int bk, int bn,
                        int subtiles, int accumulate) {
  constexpr int BM = 16 * RM;
  __shared__ float xs[BM * PITCHF];      // [m][k]
  __shared__ float ws[KCF * TN];         // [k][n]

  const Tile t = tile_of(N, bn, subtiles, BM);
  if (t.n0 >= t.n1) return;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int count = cnt[t.j];

  float acc[RM][4] = {};
  for (int s = 0; s < count; ++s) {
    const int k_lo = idx[t.j * S + s] * bk;
    const int k_hi = min(k_lo + bk, K);
    for (int k0 = k_lo; k0 < k_hi; k0 += KCF) {
      for (int i = tid; i < BM * KCF; i += THREADS) {
        const int r = i / KCF, c = i % KCF;
        const int m = t.m0 + r, k = k0 + c;
        xs[r * PITCHF + c] = (m < M && k < k_hi) ? A[m * lda + k] : 0.0f;
      }
      for (int i = tid; i < KCF * TN; i += THREADS) {
        const int r = i / TN, c = i % TN;
        const int n = t.n0 + c, k = k0 + r;
        ws[r * TN + c] = (n < t.n1 && k < k_hi) ? B[k * ldb + n] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KCF; ++k) {
        float b[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = ws[k * TN + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float a = xs[(ty + 16 * r) * PITCHF + k];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a, b[c], acc[r][c]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int m = t.m0 + ty + 16 * r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = t.n0 + tx + 16 * c;
      if (n >= t.n1) continue;
      float* dst = C + m * ldc + n;
      *dst = accumulate ? *dst + acc[r][c] : acc[r][c];
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// dtype 0: int8 A, B -> int32 C; dtype 1: f32 A, B -> f32 C.
// idx: int32 [NT, S] (S >= 1), cnt: int32 [NT], NT = ceil(N / bn); row j
// lists the non-zero K blocks (of bk rows) of columns [j bn, (j + 1) bn).
// accumulate = 0: C = A @ B over the scheduled blocks (splits must be 1);
// accumulate = 1: C += that product; on the int path the S schedule entries
// of a column may split over `splits` blocks.
extern "C" int block_sparse_launch(int dtype, const void* A, long long lda,
                                   const void* B, long long ldb, void* C,
                                   long long ldc, int M, int N, int K,
                                   const void* idx, int S, const void* cnt,
                                   int bk, int bn, int accumulate, int splits,
                                   void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || S < 1 || bk < 1 || bn < 1 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits < 1) splits = 1;
  if (splits > S) splits = S;
  const int per = (S + splits - 1) / splits;
  splits = (S + per - 1) / per;
  if (splits != 1 && (!accumulate || dtype != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = (N + bn - 1) / bn;
  const int subtiles = (bn + TN - 1) / TN;
  const bool wide = M > 32;              // 64-row tiles, else 16-row tiles
  const int bm = wide ? 64 : 16;
  const dim3 grid(nt * subtiles, (M + bm - 1) / bm, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto ix = static_cast<const int*>(idx);
  auto cn = static_cast<const int*>(cnt);
  if (dtype == 0) {
    auto a = static_cast<const int8_t*>(A);
    auto b = static_cast<const int8_t*>(B);
    auto c = static_cast<int32_t*>(C);
    if (wide)
      block_sparse_i8_kernel<4><<<grid, THREADS, 0, s>>>(
          a, lda, b, ldb, c, ldc, M, N, K, ix, S, cn, bk, bn, subtiles,
          accumulate, per);
    else
      block_sparse_i8_kernel<1><<<grid, THREADS, 0, s>>>(
          a, lda, b, ldb, c, ldc, M, N, K, ix, S, cn, bk, bn, subtiles,
          accumulate, per);
  } else {
    auto a = static_cast<const float*>(A);
    auto b = static_cast<const float*>(B);
    auto c = static_cast<float*>(C);
    if (wide)
      block_sparse_f32_kernel<4><<<grid, THREADS, 0, s>>>(
          a, lda, b, ldb, c, ldc, M, N, K, ix, S, cn, bk, bn, subtiles,
          accumulate);
    else
      block_sparse_f32_kernel<1><<<grid, THREADS, 0, s>>>(
          a, lda, b, ldb, c, ldc, M, N, K, ix, S, cn, bk, bn, subtiles,
          accumulate);
  }
  return static_cast<int>(cudaGetLastError());
}
