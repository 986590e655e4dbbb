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
// operands' type.
//
// On the card a scan carried across tiles becomes blocks that own their
// output, so that no float atomics are needed and a run is deterministic
// (a resumed training run equals an uninterrupted one bit for bit):
//   (a) flash_bwd_dot_kernel: D = rowsum(dout * out), one warp per row;
//   (b) dk and dv: one block per (batch, KV head, 64-key tile) loops over
//       the group's query heads and the query tiles that see its keys,
//       recomputing s and p, and keeps dk and dv for its keys in registers
//       until it writes them once;
//   (c) dq: one block per (batch, head, 64-query tile) loops over the key
//       tiles its queries see and writes dq once.
// (b) and (c) both recompute s = q k^T and dp = dout v^T: seven products
// in all where the JAX function's scan takes five.
//
// bfloat16 (the training path): flash_bwd_dkdv_mma_kernel and
// flash_bwd_dq_mma_kernel, four warps of 16 rows a block over tiles of 32,
// every product on the tensor cores as mma.sync m16n8k16 (bf16 operands
// through ldmatrix from padded shared memory, float32 accumulators).  (b)
// computes the transposed scores s^T = k q^T, so p^T and ds^T leave their
// accumulators as the A operands of dv += p^T dout and dk += ds^T q without
// a trip through shared memory; (c) does the same for dq += ds k.  p enters
// its product rounded once to bf16; ds enters as two bf16 terms, ds_hi +
// ds_lo, as the forward kernel splits p: each row of ds sums to zero, and
// with one rounding a row whose query sees few keys lost that cancellation
// (q.grad off by 0.027 at a value of 0.11 on an H100 with dout = 2 out).
// The head dimension is padded to a multiple of 16 (a template argument, so
// the accumulators are register arrays).
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
// ms.  mma.sync reaches only part of the wgmma peak, and the two
// recomputed products add 40 %; wgmma fed by TMA, as the forward kernel
// is, is the later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // 16 x 16
constexpr int BQ = 64;         // query rows of a tile: ty + 16 r, r < 4
constexpr int BK = 64;         // keys of a tile: tx + 16 c, c < 4
constexpr int DMAX = 128;      // accumulator columns tx + 16 c, c < 8

struct Strides {
  long long b, h, s;           // elements between batches, heads, positions
};

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
                                              int tx, int ty) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qpos = q0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kpos = k0 + tx + 16 * c;
      const bool seen =
          qpos < Sq && kpos < Sk && !(causal && qpos < kpos);
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
                      int causal) {
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

  // top-left causal: a query tile ending before k0 sees none of these keys
  const int qt0 = causal ? k0 / BQ : 0;
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
      probabilities(p, ls, q0, k0, Sq, Sk, scale, causal, tx, ty);
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
                    float scale, int causal) {
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
  if (causal) nkt = min(nkt, (min(q0 + BQ, Sq) - 1) / BK + 1);

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
    probabilities(p, ls, q0, k0, Sq, Sk, scale, causal, tx, ty);
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
// bfloat16: mma.sync tensor cores
// ------------------------------------------------------------------------- //

constexpr int M_THREADS = 128;   // 4 warps of 16 rows each
constexpr int M_ROWS = 64;       // keys (dk / dv) or queries (dq) of a block
constexpr int M_TILE = 32;       // queries (dk / dv) or keys (dq) of a tile

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory, each lane naming one row.
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 operands, float32 accumulator
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + n) of one (batch, head) of `src` into dst [n][DP + 8],
// zeros beyond `rows` and in columns D..DP-1; 16-byte copies when `vec`
// (D % 8 == 0, 16-byte aligned base and strides)
template <int DP>
__device__ __forceinline__ void load_bf16(bf16* dst, const bf16* src,
                                          long long row_stride, int r0,
                                          int n, int rows, int D, int vec) {
  constexpr int LD = DP + 8;
  if (vec) {
    for (int i = threadIdx.x; i < n * (DP / 8); i += M_THREADS) {
      const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < rows && c < D)
        val = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride + c);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < n * DP; i += M_THREADS) {
      const int r = i / DP, c = i % DP;
      dst[r * LD + c] = r0 + r < rows && c < D
                            ? src[(r0 + r) * row_stride + c]
                            : __float2bfloat16(0.0f);
    }
  }
}

// out[16 x 32] = a[16 rows of A, DP] b[32 rows of B, DP]^T: a warp's rows
// against a tile's 32 rows over the head dimension, four n-tiles of 8
template <int DP>
__device__ __forceinline__ void rows_dot(float (&out)[4][4], const bf16* a,
                                         const bf16* b, int lane) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[n][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t af[4];
    ldsm(af, a + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) {
      uint32_t bf[4];
      ldsm(bf, b + (n2 * 16 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 +
                   ((lane / 8) % 2) * 8);
      mma(out[2 * n2], af, bf[0], bf[1]);
      mma(out[2 * n2 + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[16 x DP] += w[16 x 32] x[32 rows, DP]: w from a 16 x 32 accumulator
// (the C fragments of rows_dot) as bf16 A fragments, x read transposed
// from shared memory.  With SPLIT, w enters as two bf16 terms, w = w_hi +
// w_lo, two products into the one accumulator (~2^-17 relative, as the
// forward kernel splits p)
template <int DP, bool SPLIT>
__device__ __forceinline__ void acc_rows(float (&acc)[DP / 8][4],
                                         const float (&w)[4][4],
                                         const bf16* x, int lane) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int k2 = 0; k2 < 2; ++k2) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = w[2 * k2 + i / 2][(i % 2) * 2];
      const float b = w[2 * k2 + i / 2][(i % 2) * 2 + 1];
      hi[i] = bf16x2(a, b);
      if constexpr (SPLIT) {
        const __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&hi[i]);
        lo[i] = bf16x2(a - __low2float(h), b - __high2float(h));
      }
    }
#pragma unroll
    for (int n2 = 0; n2 < DP / 16; ++n2) {
      uint32_t bf[4];
      ldsm_t(bf, x + (k2 * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                     n2 * 16 + (lane / 16) * 8);
      mma(acc[2 * n2], hi, bf[0], bf[1]);
      mma(acc[2 * n2 + 1], hi, bf[2], bf[3]);
      if constexpr (SPLIT) {
        mma(acc[2 * n2], lo, bf[0], bf[1]);
        mma(acc[2 * n2 + 1], lo, bf[2], bf[3]);
      }
    }
  }
}

template <int DP>
__device__ __forceinline__ void store_rows(bf16* dst, long long row_stride,
                                           const float (&acc)[DP / 8][4],
                                           float mul, int row0, int rows,
                                           int D, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h, col = n * 8 + 2 * t;
      if (row >= rows) continue;
      bf16* p = dst + row * row_stride + col;
      if (col + 1 < D) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(
            acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
      } else if (col < D) {
        *p = __float2bfloat16_rn(acc[n][2 * h] * mul);
      }
    }
}

template <int DP>
__host__ __device__ constexpr int mma_smem_bytes() {
  return 2 * (M_ROWS + M_TILE) * (DP + 8) * 2 + 2 * M_ROWS * 4;
}

// (b) on the tensor cores: dk and dv of 64 keys, 16 a warp, over query
// tiles of 32; the transposed scores s^T = k q^T are computed directly, so
// p^T and ds^T leave their accumulators as the A operands of dv += p^T dout
// and dk += ds^T q
template <int DP>
__global__ void __launch_bounds__(M_THREADS)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, Strides sq,
                          const bf16* __restrict__ k, Strides sk,
                          const bf16* __restrict__ v, Strides sv,
                          const bf16* __restrict__ dout, Strides sdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ dvec,
                          bf16* __restrict__ dk, Strides sdk,
                          bf16* __restrict__ dv, Strides sdv, int H, int Hkv,
                          int Sq, int Sk, int D, float scale, int causal,
                          int vec) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [64][LD]
  bf16* vs = ks + M_ROWS * LD;                     // [64][LD]
  bf16* qs = vs + M_ROWS * LD;                     // [32][LD]
  bf16* dos = qs + M_TILE * LD;                    // [32][LD]
  float* ls = reinterpret_cast<float*>(dos + M_TILE * LD);   // [32] lse
  float* ds = ls + M_ROWS;                                    // [32] D

  const int k0 = blockIdx.x * M_ROWS;   // the longest causal loops first
  const long long bi = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int group = H / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kw = k0 + 16 * warp;        // the warp's first key

  load_bf16<DP>(ks, k + bi * sk.b + hk * sk.h, sk.s, k0, M_ROWS, Sk, D, vec);
  load_bf16<DP>(vs, v + bi * sv.b + hk * sv.h, sv.s, k0, M_ROWS, Sk, D, vec);

  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

  const int qt0 = causal ? k0 / M_TILE : 0;
  const int nqt = (Sq + M_TILE - 1) / M_TILE;
  for (int gh = 0; gh < group; ++gh) {
    const long long hi = hk * group + gh;
    const bf16* qh = q + bi * sq.b + hi * sq.h;
    const bf16* doh = dout + bi * sdo.b + hi * sdo.h;
    const float* lh = lse + (bi * H + hi) * Sq;
    const float* dh = dvec + (bi * H + hi) * Sq;
    for (int qt = qt0; qt < nqt; ++qt) {
      const int q0 = qt * M_TILE;
      __syncthreads();               // the previous tile is no longer read
      load_bf16<DP>(qs, qh, sq.s, q0, M_TILE, Sq, D, vec);
      load_bf16<DP>(dos, doh, sdo.s, q0, M_TILE, Sq, D, vec);
      if (threadIdx.x < M_TILE) {
        const int i = q0 + threadIdx.x;
        ls[threadIdx.x] = i < Sq ? lh[i] : 0.0f;
        ds[threadIdx.x] = i < Sq ? dh[i] : 0.0f;
      }
      __syncthreads();

      float p[4][4], dp[4][4];
      rows_dot<DP>(p, ks + 16 * warp * LD, qs, lane);      // s^T
      rows_dot<DP>(dp, vs + 16 * warp * LD, dos, lane);    // dp^T
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw + g + (e / 2) * 8;
          const int col = n * 8 + 2 * t + e % 2, query = q0 + col;
          const bool seen =
              query < Sq && key < Sk && !(causal && query < key);
          p[n][e] = seen ? expf(p[n][e] * scale - ls[col]) : 0.0f;
          dp[n][e] = p[n][e] * (dp[n][e] - ds[col]);       // ds^T
        }
      acc_rows<DP, false>(dva, p, dos, lane);              // dv += p^T dout
      acc_rows<DP, true>(dka, dp, qs, lane);               // dk += ds^T q
    }
  }
  store_rows<DP>(dk + bi * sdk.b + hk * sdk.h, sdk.s, dka, scale, kw, Sk, D,
                 lane);
  store_rows<DP>(dv + bi * sdv.b + hk * sdv.h, sdv.s, dva, 1.0f, kw, Sk, D,
                 lane);
}

// (c) on the tensor cores: dq of 64 queries, 16 a warp, over key tiles of 32
template <int DP>
__global__ void __launch_bounds__(M_THREADS)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, Strides sq,
                        const bf16* __restrict__ k, Strides sk,
                        const bf16* __restrict__ v, Strides sv,
                        const bf16* __restrict__ dout, Strides sdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ dvec,
                        bf16* __restrict__ dq, Strides sdq, int H, int Hkv,
                        int Sq, int Sk, int D, float scale, int causal,
                        int vec) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [64][LD]
  bf16* dos = qs + M_ROWS * LD;                    // [64][LD]
  bf16* ks = dos + M_ROWS * LD;                    // [32][LD]
  bf16* vs = ks + M_TILE * LD;                     // [32][LD]
  float* ls = reinterpret_cast<float*>(vs + M_TILE * LD);    // [64] lse
  float* ds = ls + M_ROWS;                                    // [64] D

  const int nqt = (Sq + M_ROWS - 1) / M_ROWS;
  const int q0 = (nqt - 1 - blockIdx.x) * M_ROWS;   // longest rows first
  const long long bi = blockIdx.y / H, hi = blockIdx.y % H;
  const long long hk = hi / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int qw = q0 + 16 * warp;        // the warp's first query

  load_bf16<DP>(qs, q + bi * sq.b + hi * sq.h, sq.s, q0, M_ROWS, Sq, D, vec);
  load_bf16<DP>(dos, dout + bi * sdo.b + hi * sdo.h, sdo.s, q0, M_ROWS, Sq,
                D, vec);
  if (threadIdx.x < M_ROWS) {
    const int i = q0 + threadIdx.x;
    const long long at = (bi * H + hi) * Sq + i;
    ls[threadIdx.x] = i < Sq ? lse[at] : 0.0f;
    ds[threadIdx.x] = i < Sq ? dvec[at] : 0.0f;
  }
  const bf16* kh = k + bi * sk.b + hk * sk.h;
  const bf16* vh = v + bi * sv.b + hk * sv.h;
  int nkt = (Sk + M_TILE - 1) / M_TILE;
  if (causal) nkt = min(nkt, (min(q0 + M_ROWS, Sq) - 1) / M_TILE + 1);

  float dqa[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.0f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * M_TILE;
    __syncthreads();                 // the previous tile is no longer read
    load_bf16<DP>(ks, kh, sk.s, k0, M_TILE, Sk, D, vec);
    load_bf16<DP>(vs, vh, sv.s, k0, M_TILE, Sk, D, vec);
    __syncthreads();

    float p[4][4], dp[4][4];
    rows_dot<DP>(p, qs + 16 * warp * LD, ks, lane);        // s
    rows_dot<DP>(dp, dos + 16 * warp * LD, vs, lane);      // dp
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * warp + g + (e / 2) * 8, query = q0 + row;
        const int key = k0 + n * 8 + 2 * t + e % 2;
        const bool seen = query < Sq && key < Sk && !(causal && query < key);
        const float pv = seen ? expf(p[n][e] * scale - ls[row]) : 0.0f;
        p[n][e] = pv * (dp[n][e] - ds[row]);               // ds
      }
    acc_rows<DP, true>(dqa, p, ks, lane);                  // dq += ds k
  }
  store_rows<DP>(dq + bi * sdq.b + hi * sdq.h, sdq.s, dqa, scale, qw, Sq, D,
                 lane);
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
               cudaStream_t stream) {
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
          H, Hkv, Sq, Sk, D, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel
      <<<dim3((Sq + BQ - 1) / BQ, B * H), THREADS, bytes, stream>>>(
          q, a.sq, k, a.sk, v, a.sv, dout, a.sdo, lse, dvec,
          static_cast<float*>(a.dq), a.sdq, H, Hkv, Sq, Sk, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_mma(const Operands& a, const float* lse, const float* dvec, int B,
               int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,
               int vec, cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_mma_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  flash_bwd_dkdv_mma_kernel<DP>
      <<<dim3((Sk + M_ROWS - 1) / M_ROWS, B * Hkv), M_THREADS, bytes,
         stream>>>(q, a.sq, k, a.sk, v, a.sv, dout, a.sdo, lse, dvec,
                   static_cast<bf16*>(a.dk), a.sdk, static_cast<bf16*>(a.dv),
                   a.sdv, H, Hkv, Sq, Sk, D, scale, causal, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_mma_kernel<DP>
      <<<dim3((Sq + M_ROWS - 1) / M_ROWS, B * H), M_THREADS, bytes,
         stream>>>(q, a.sq, k, a.sk, v, a.sv, dout, a.sdo, lse, dvec,
                   static_cast<bf16*>(a.dq), a.sdq, H, Hkv, Sq, Sk, D, scale,
                   causal, vec);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int launch_bf16(const Operands& a, const float* lse, float* dvec, int B,
                int H, int Hkv, int Sq, int Sk, int D, float scale,
                int causal, cudaStream_t stream) {
  const int rc = launch_dot<bf16>(a, dvec, B, H, Sq, D, stream);
  if (rc != 0) return rc;
  // 16-byte tile loads where every operand row allows them
  int vec = D % 8 == 0;
  const void* bases[4] = {a.q, a.k, a.v, a.dout};
  const Strides strides[4] = {a.sq, a.sk, a.sv, a.sdo};
  for (int i = 0; i < 4; ++i)
    vec = vec && aligned16(bases[i]) && strides[i].b % 8 == 0 &&
          strides[i].h % 8 == 0 && strides[i].s % 8 == 0;
  // the head dimension padded to 16 is a template argument, so the
  // accumulators are register arrays of static size
  static int (*const by_width[8])(const Operands&, const float*,
                                   const float*, int, int, int, int, int,
                                   int, float, int, int, cudaStream_t) = {
      launch_mma<16>, launch_mma<32>, launch_mma<48>, launch_mma<64>,
      launch_mma<80>, launch_mma<96>, launch_mma<112>, launch_mma<128>};
  return by_width[(D + 15) / 16 - 1](a, lse, dvec, B, H, Hkv, Sq, Sk, D,
                                     scale, causal, vec, stream);
}

}  // namespace

// Launches the three kernels on `stream`; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a call they do not take.
// dtype 0: float32 operands and gradients, 1: bfloat16.  q, out, dout and dq
// are indexed [batch, head, position, d], k, v, dk and dv [batch, kv head,
// position, d], each through the three strides given for it (in elements),
// d with unit stride.  `lse` is the forward's float32 [B, H, Sq] log-sum-exp
// (contiguous); `dvec` float32 [B, H, Sq] scratch that receives D.
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
    int causal, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Sk < 1 ||
      D < 1 || D > DMAX || B * H > 65535 || (dtype != 0 && dtype != 1))
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
    return launch_f32(a, l, rowdot, B, H, Hkv, Sq, Sk, D, scale, causal, s);
  return launch_bf16(a, l, rowdot, B, H, Hkv, Sq, Sk, D, scale, causal, s);
}
