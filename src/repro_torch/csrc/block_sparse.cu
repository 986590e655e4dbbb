// block_sparse: C[M, N] (+)= A[M, K] @ B[K, N] over the non-zero blocks of a
// CSR-of-blocks schedule (the paper's zero-tile book, ZTB).
//
// Replaces the TPU kernel `_block_sparse_kernel` / `block_sparse_matmul` of
// src/repro/kernels/block_sparse/kernel.py.  That Pallas kernel walks a grid
// (M tile, N-tile column j, step s) whose third axis runs in order and carries
// an f32 VMEM accumulator; scalar prefetch brings the schedule
// (`idx[j, :cnt[j]]`, the non-zero K blocks of column j) so that the
// BlockSpec index maps DMA only non-zero blocks.  Here blocks run in parallel
// and in no order, so one thread block per (M tile, N tile of column j) runs
// the loop `for s < cnt[j]` itself and keeps the sum in registers.  A zero
// block is never loaded; a column with cnt[j] == 0 loads nothing (it writes
// zeros, or leaves C untouched when accumulating).  Schedule blocks are
// bk x bn; the last block row and column may be ragged, and M, N and K edges
// are masked with zeros.  Leading-dimension strides are passed in (unit
// stride along the last axis), so strided views go in uncopied.
//
// What bounds it on an H100: the work is the non-zero blocks only.  At the
// +ZTB path's shapes (M = 512 prefill projections, M = 16 MoE expert steps)
// reading x and the non-zero blocks once is the bound (0.1-0.6 us); the
// int8 tensor-core rate would need M in the thousands to bind first.
//
// int8 x int8 -> int32, exact: the tensor-core body shared with bitlinear.cu
// (int8_mma.cuh), mma.sync m16n8k32 with x as A (rows m, K-contiguous, as
// stored) and w as B.  B fragments must hold 4 consecutive K values of one
// column, but w is N-contiguous: each thread reads one 32-bit word (four
// neighbouring columns) from each of four staged K rows and byte-transposes
// them in registers, so w is transposed on the way from shared memory to
// the MMA and no K-major copy of it exists anywhere (a copy per plan would
// double the weights' memory for a transposition that costs 8 byte
// permutes per 4 x 4 bytes).  The MMA columns are permuted so that the four
// columns of one word are column g of four MMAs.  The block runs its
// column's schedule through a ring of 64-deep K stages in shared memory,
// filled by 16-byte cp.async copies of x and w (w's 16-byte chunks
// swizzled so that the fragment reads hit distinct banks), every slot of
// the 3- or 4-deep ring in flight at once; the schedule index of the next
// non-zero block is read one entry ahead of the copies (the analogue of
// scalar prefetch).  A block covers all bn <= 128 columns of a schedule
// column, so each x block is staged once per (M tile, schedule column).
// To fill the SMs at small M x N, an accumulating call may split a
// column's schedule entries over gridDim.z blocks that add their partial
// sums with integer atomics (exact in any order).  wgmma is not used: no
// shape of the path is bound by operations.
//
// f32 x f32 -> f32 keeps its CUDA-core body: FMA in schedule order through
// shared memory, one 16 x 16-thread block per 64-column sub-tile, staged
// with 16-byte loads where the rows allow them (checked at rtol 1e-4 /
// atol 1e-3; it is not on the int path).
#include "int8_mma.cuh"

namespace {

using namespace i8mma;

constexpr int TN = 64;                   // f32: output columns per block
constexpr int THREADS = 256;             // f32: 16 x 16, 4 columns x RM rows each
constexpr int KCF = 32;                  // f32 K values staged per step
constexpr int PITCHF = KCF + 1;
constexpr int BK = 64;                   // int8: K values per pipeline stage
constexpr int XPITCH = BK + 16;          // int8: bytes per staged x row (20 words)
constexpr int MIN_STEPS = 4;             // int8: K stages a split block runs at least

struct Tile {
  int j, n0, n1, m0;                     // schedule column, columns [n0, n1), first row
};

__device__ __forceinline__ Tile tile_of(int N, int bn, int subtiles, int bm,
                                        int tn = TN) {
  Tile t;
  t.j = blockIdx.x / subtiles;
  const int part = blockIdx.x % subtiles;
  t.n0 = t.j * bn + part * tn;
  t.n1 = min(min(t.n0 + tn, (t.j + 1) * bn), N);
  t.m0 = blockIdx.y * bm;
  return t;
}

// WM x WN warps; a warp owns 16 MT rows x 32 columns.
template <int WM, int MT, int WN>
__global__ void __launch_bounds__(32 * WM * WN)
block_sparse_i8_mma_kernel(const uint8_t* __restrict__ A, long long lda,
                           const uint8_t* __restrict__ B, long long ldb,
                           int32_t* __restrict__ C, long long ldc, int M,
                           int N, int K, const int* __restrict__ idx, int S,
                           const int* __restrict__ cnt, int bk, int bn,
                           int subtiles, int accumulate, int per_split,
                           int flags) {
  constexpr int NT = 32 * WM * WN;
  constexpr int BM = 16 * MT * WM;
  constexpr int BN = 32 * WN;
  constexpr int WPITCH = BN + 16;        // bytes per staged w row
  constexpr int STAGE_BYTES = BM * XPITCH + BK * WPITCH;
  constexpr int STAGES = 4 * STAGE_BYTES <= 48 * 1024 ? 4 : 3;
  __shared__ __align__(128) uint8_t xs[STAGES][BM * XPITCH];
  __shared__ __align__(128) uint8_t ws[STAGES][BK * WPITCH];

  const Tile tl = tile_of(N, bn, subtiles, BM, BN);
  if (tl.n0 >= tl.n1) return;
  const int count = cnt[tl.j];
  const int s0 = blockIdx.z * per_split;
  const int s1 = min(s0 + per_split, count);
  if (accumulate && s0 >= s1) return;    // nothing to add
  const int cpe = (bk + BK - 1) / BK;    // stages per schedule entry
  const int steps = max(s1 - s0, 0) * cpe;
  const bool a16 = flags & 1, b16 = flags & 2;
  const int* col_idx = idx + static_cast<long long>(tl.j) * S;

  // the producer's place in the schedule: entry e_load, stage sub_load of
  // it; blk_next is read one entry ahead of the copies
  int e_load = s0, sub_load = 0;
  int blk_cur = s0 < s1 ? col_idx[s0] : 0;
  int blk_next = s0 + 1 < s1 ? col_idx[s0 + 1] : 0;

  auto load = [&](int slot) {
    const int k_lo = blk_cur * bk;
    const int k0 = k_lo + sub_load * BK;
    const int k_hi = min(k_lo + bk, K);
#pragma unroll
    for (int j = 0; j < (BM * (BK / 16) + NT - 1) / NT; ++j) {
      const int i = threadIdx.x + j * NT;
      if (i < BM * (BK / 16)) {
        const int r = i / (BK / 16), c = i % (BK / 16);
        const int m = tl.m0 + r, k = k0 + c * 16;
        const int bytes = m < M ? min(max(k_hi - k, 0), 16) : 0;
        stage16(&xs[slot][r * XPITCH + c * 16], bytes ? A + m * lda + k : A,
                bytes, a16);
      }
    }
#pragma unroll
    for (int j = 0; j < (BK * (BN / 16) + NT - 1) / NT; ++j) {
      const int i = threadIdx.x + j * NT;
      if (i < BK * (BN / 16)) {
        const int r = i / (BN / 16), c = i % (BN / 16);
        const int k = k0 + r, n = tl.n0 + c * 16;
        const int bytes = k < k_hi ? min(max(tl.n1 - n, 0), 16) : 0;
        const int swizzled = c ^ (((r >> 3) & 1) << 1);
        stage16(&ws[slot][r * WPITCH + swizzled * 16],
                bytes ? B + k * ldb + n : B, bytes, b16);
      }
    }
    if (++sub_load == cpe) {
      sub_load = 0;
      ++e_load;
      blk_cur = blk_next;
      blk_next = e_load + 1 < s1 ? col_idx[e_load + 1] : 0;
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int gq = lane >> 2, t = lane & 3;
  const int cw = wn * 8 + gq;            // this thread's w word column (4 n)

  // w word of staged row r, word column cw, through the swizzle
  auto wword = [&](const uint8_t* W, int r) -> uint32_t {
    const int c = (cw >> 2) ^ (((r >> 3) & 1) << 1);
    return *reinterpret_cast<const uint32_t*>(W + r * WPITCH + c * 16 +
                                              (cw & 3) * 4);
  };

  int acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][q][v] = 0;

  // every slot filled up front; a refill takes the slot consumed one step
  // before (one barrier a step), copy group g carrying stage g, as in
  // bitlinear.cu
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    if (step == 0) {
      cp_async_wait<STAGES - 1>();
    } else {
      cp_async_wait<STAGES - 2>();
    }
    __syncthreads();
    if (step > 0) {
      if (step - 1 + STAGES < steps) load((step - 1) % STAGES);
      cp_async_commit();
    }
    const uint8_t* X = xs[step % STAGES];
    const uint8_t* W = ws[step % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      // B fragments: blo[q] / bhi[q] hold K values 4t..4t+3 / 16+4t..+3 of
      // column 4 gq + q, which is column gq of MMA q
      uint32_t blo[4], bhi[4];
      const int r = kk * 32 + 4 * t;
      transpose4(wword(W, r), wword(W, r + 1), wword(W, r + 2),
                 wword(W, r + 3), blo);
      transpose4(wword(W, r + 16), wword(W, r + 17), wword(W, r + 18),
                 wword(W, r + 19), bhi);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int row = (wm * MT + i) * 16 + gq;
        const uint32_t* x0 =
            reinterpret_cast<const uint32_t*>(X + row * XPITCH);
        const uint32_t* x8 =
            reinterpret_cast<const uint32_t*>(X + (row + 8) * XPITCH);
        const uint32_t a0 = x0[kk * 8 + t], a1 = x8[kk * 8 + t];
        const uint32_t a2 = x0[kk * 8 + 4 + t], a3 = x8[kk * 8 + 4 + t];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mma_s8(acc[i][q], a0, a1, a2, a3, blo[q], bhi[q]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int m = tl.m0 + (wm * MT + i) * 16 + gq + (v >> 1) * 8;
        const int n = tl.n0 + wn * 32 + 4 * (2 * t + (v & 1)) + q;
        if (m >= M || n >= tl.n1) continue;
        int32_t* dst = C + m * ldc + n;
        if (accumulate) {
          atomicAdd(dst, acc[i][q][v]);
        } else {
          *dst = acc[i][q][v];
        }
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
                        int subtiles, int accumulate, int flags) {
  constexpr int BM = 16 * RM;
  __shared__ float xs[BM * PITCHF];      // [m][k]
  __shared__ __align__(16) float ws[KCF * TN];   // [k][n]
  const bool a16 = flags & 1, b16 = flags & 2;   // 16-byte loads allowed

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
      for (int i = tid; i < BM * KCF / 4; i += THREADS) {
        const int r = i / (KCF / 4), c = (i % (KCF / 4)) * 4;
        const int m = t.m0 + r, k = k0 + c;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (a16 && m < M && k + 4 <= k_hi) {
          v = *reinterpret_cast<const float4*>(A + m * lda + k);
        } else if (m < M) {
          const float* src = A + m * lda + k;
          v.x = k < k_hi ? src[0] : 0.0f;
          v.y = k + 1 < k_hi ? src[1] : 0.0f;
          v.z = k + 2 < k_hi ? src[2] : 0.0f;
          v.w = k + 3 < k_hi ? src[3] : 0.0f;
        }
        float* dst = xs + r * PITCHF + c;
        dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
      }
      for (int i = tid; i < KCF * TN / 4; i += THREADS) {
        const int r = i / (TN / 4), c = (i % (TN / 4)) * 4;
        const int n = t.n0 + c, k = k0 + r;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (b16 && k < k_hi && n + 4 <= t.n1) {
          v = *reinterpret_cast<const float4*>(B + k * ldb + n);
        } else if (k < k_hi) {
          const float* src = B + k * ldb + n;
          v.x = n < t.n1 ? src[0] : 0.0f;
          v.y = n + 1 < t.n1 ? src[1] : 0.0f;
          v.z = n + 2 < t.n1 ? src[2] : 0.0f;
          v.w = n + 3 < t.n1 ? src[3] : 0.0f;
        }
        *reinterpret_cast<float4*>(ws + r * TN + c) = v;
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
// accumulate = 0: C = A @ B over the scheduled blocks;
// accumulate = 1: C += that product; on the int path the S schedule entries
// of a column then split over enough blocks to give the card's `sms`
// multiprocessors two blocks each, each block running at least MIN_STEPS
// K stages.
extern "C" int block_sparse_launch(int dtype, const void* A, long long lda,
                                   const void* B, long long ldb, void* C,
                                   long long ldc, int M, int N, int K,
                                   const void* idx, int S, const void* cnt,
                                   int bk, int bn, int accumulate, int sms,
                                   void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || S < 1 || bk < 1 || bn < 1 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = (N + bn - 1) / bn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto ix = static_cast<const int*>(idx);
  auto cn = static_cast<const int*>(cnt);
  if (dtype == 0) {
    auto a = static_cast<const uint8_t*>(A);
    auto b = static_cast<const uint8_t*>(B);
    auto c = static_cast<int32_t*>(C);
    const int wn = bn <= 64 ? 2 : 4;       // 64 or 128 columns per block
    const int bn_blk = 32 * wn;
    const int wm = M <= 16 ? 1 : 2;
    const int mt = M <= 32 ? 1 : 2;
    const int bm = 16 * mt * wm;
    const int subtiles = (bn + bn_blk - 1) / bn_blk;
    const long long tiles =
        static_cast<long long>(nt) * subtiles * ((M + bm - 1) / bm);
    // split only accumulating calls (partial sums add with atomics)
    const int cpe = (bk + BK - 1) / BK;
    int splits = 1;
    if (accumulate) {
      const long long target = 2LL * (sms > 0 ? sms : 1);
      const int want = tiles < target
                           ? static_cast<int>((target + tiles - 1) / tiles) : 1;
      const int min_per = (MIN_STEPS + cpe - 1) / cpe;
      const int most = (S + min_per - 1) / min_per;
      splits = want < most ? want : most;
      if (splits < 1) splits = 1;
    }
    const int per = (S + splits - 1) / splits;
    splits = (S + per - 1) / per;
    const int flags = ((reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                        lda % 16 == 0 && bk % 16 == 0) ? 1 : 0) |
                      ((reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
                        ldb % 16 == 0 && bn % 16 == 0) ? 2 : 0);
    const dim3 grid(nt * subtiles, (M + bm - 1) / bm, splits);
#define BLOCK_SPARSE_CASE(WM_, MT_, WN_)                                 \
    if (wm == WM_ && mt == MT_ && wn == WN_) {                               \
      block_sparse_i8_mma_kernel<WM_, MT_, WN_>                              \
          <<<grid, 32 * WM_ * WN_, 0, s>>>(a, lda, b, ldb, c, ldc, M, N, K,  \
                                           ix, S, cn, bk, bn, subtiles,      \
                                           accumulate, per, flags);          \
      return static_cast<int>(cudaGetLastError());                           \
    }
    BLOCK_SPARSE_CASE(1, 1, 2) BLOCK_SPARSE_CASE(1, 1, 4)
    BLOCK_SPARSE_CASE(2, 1, 2) BLOCK_SPARSE_CASE(2, 1, 4)
    BLOCK_SPARSE_CASE(2, 2, 2) BLOCK_SPARSE_CASE(2, 2, 4)
#undef BLOCK_SPARSE_CASE
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const int subtiles = (bn + TN - 1) / TN;
    const bool wide = M > 32;              // 64-row tiles, else 16-row tiles
    const int bm = wide ? 64 : 16;
    const dim3 grid(nt * subtiles, (M + bm - 1) / bm, 1);
    const int flags = ((reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                        lda % 4 == 0 && bk % 4 == 0) ? 1 : 0) |
                      ((reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
                        ldb % 4 == 0 && bn % 4 == 0) ? 2 : 0);
    auto a = static_cast<const float*>(A);
    auto b = static_cast<const float*>(B);
    auto c = static_cast<float*>(C);
    if (wide)
      block_sparse_f32_kernel<4><<<grid, THREADS, 0, s>>>(
          a, lda, b, ldb, c, ldc, M, N, K, ix, S, cn, bk, bn, subtiles,
          accumulate, flags);
    else
      block_sparse_f32_kernel<1><<<grid, THREADS, 0, s>>>(
          a, lda, b, ldb, c, ldc, M, N, K, ix, S, cn, bk, bn, subtiles,
          accumulate, flags);
  }
  return static_cast<int>(cudaGetLastError());
}
