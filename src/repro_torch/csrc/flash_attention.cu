// flash_attention: online-softmax attention, causal or full, with GQA.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention/kernel.py.  That Pallas kernel walks a
// grid (b*h, q tile, kv tile) whose kv axis runs in order and carries the
// running max m, sum l and accumulator acc in VMEM scratch; a BlockSpec index
// map points each query head at its KV head (h / (H / Hkv)), and kv tiles
// wholly in the causal future are skipped.  Both kernels here keep its
// conventions: masked scores take -1e30, keys beyond Sk take -inf, the
// causal mask is top-left (q position >= k position, also when Sq != Sk),
// kv tiles run in ascending order from tile 0 (key 0 sets a real row maximum
// first, so exp(s - m) of a masked score is 0), and the output is
// acc / max(l, 1e-30) in q's type.  q, k, v and o are read through
// (batch, head, position) strides with unit stride along the head dimension,
// so [B, S, H, d] tensors and their [B, H, S, d] transposes go in uncopied.
// A query offset places query row i at position q_offset + i, as the JAX
// package's _tile_scores does for a context-parallel shard
// (src/repro/models/attention.py): the causal mask, the last kv tile a
// block loads and the diagonal-tile test all read the shifted position, so
// a shard of the queries at offset o computes exactly the rows o.. of the
// whole-sequence call.  The longest causal rows still go first: the block
// order is the same, every row longer by the offset.
// For training, both kernels also write each row's log-sum-exp m + log(l)
// (natural log, float32) when given an `lse` pointer: the residual that the
// backward (flash_attention_bwd.cu) recomputes the probabilities from, as
// the JAX package's custom VJP saves it (src/repro/models/attention.py,
// _flash_fwd).  Serving passes null, and its epilogue is unchanged.
//
// bfloat16 (the Zamba2-7B serve path): flash_kernel_bf16_wgmma, shaped after
// FlashAttention-3 for Hopper.  A block of 384 threads owns 128 query rows
// of one (batch, head): two consumer warpgroups of 64 rows each and one
// producer warpgroup that lowers its registers with setmaxnreg and from one
// thread keeps K and V tiles of 128 keys in flight through TMA into a
// two-stage ring, with mbarriers for full and empty slots; Q is loaded once.
// The head dimension is taken to 128 in shared memory as two 64-column TMA
// boxes with the 128-byte swizzle, and TMA's out-of-bounds fill supplies
// the zero columns d..127 and the zero rows beyond Sq and Sk, so any
// d <= 128 that is a multiple of 8 runs the one kernel.  S = Q K^T is wgmma
// with both operands in shared memory and a float32 accumulator; the online
// softmax stays in float32 registers; O += P V is wgmma with P from registers
// and V read transposed from shared memory, in two products split at the
// TMA box (n = 64 and n = 16 KS - 64; KS = ceil(d / 16) is a template
// argument, so no product is issued under a run-time condition, which makes
// ptxas serialize them).  P goes in as two bf16 terms, P = P_hi + P_lo, two
// wgmma into one float32 accumulator: P rounded once to bf16 (as SDPA does)
// misses the float32 plain version by ~2^-9 relative, the split by ~2^-17,
// leaving the output's own bf16 rounding.  The softmax takes the row max
// over the raw scores and each probability as one FFMA and one ex2, which
// halved its share of the time.  Causal tiles wholly in the future are not
// loaded, only diagonal and ragged tiles are masked, and the longest rows go
// first.  The two consumer warpgroups run in step (the S product, softmax,
// the O product); ping-pong turns between them and issuing O of one tile
// with S of the next were both slower on an H100 (0.64 ms against 0.50 ms
// before the lighter softmax), the register pressure of holding S, P and O
// at once being the likely cause.
//
// float32 (the reduced card-against-CPU checks): flash_kernel_f32, one
// 256-thread block per 64 query rows on the CUDA cores, products as float32
// FMA from shared memory with 4 x 4 score and 4 x 8 accumulator register
// tiles per thread.
//
// What bounds it on an H100: at Zamba2-7B's long-prompt prefill (B = 1,
// H = Hkv = 32, S = 4096, d = 112, causal) the two products take ~1.2e11
// FLOP against ~117 MB of q, k, v and o in bf16: 0.12 ms at the bf16
// tensor-core peak (0.18 ms for the work with the split P), 0.035 ms for the
// bytes.  The diagonal tiles add ~3 % to the tensor-core work.  Later steps:
// overlap of the softmax with the tensor cores within the register budget
// (P through shared memory), a persistent grid; the float32 kernel stays on
// the CUDA cores.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int THREADS = 256;   // 16 x 16
constexpr int BQ = 64;         // query rows of a block: ty + 16 r, r < 4
constexpr int BK = 64;         // keys of a kv tile: tx + 16 c, c < 4
constexpr int DMAX = 128;      // accumulator columns tx + 16 c, c < 8
constexpr float NEG_BIG = -1e30f;

__host__ __device__ inline int smem_floats(int d) {
  return 2 * BQ * (d + 1) + BK * d + BQ * (BK + 1);
}

__global__ void __launch_bounds__(THREADS)
flash_kernel_f32(const float* __restrict__ q, Strides sq,
                 const float* __restrict__ k, Strides sk,
                 const float* __restrict__ v, Strides sv,
                 float* __restrict__ o, Strides so, float* __restrict__ lse,
                 int H, int Hkv, int Sq, int Sk, int D, float scale,
                 int causal, int q_offset) {
  extern __shared__ float smem[];
  const int pd = D + 1;
  float* qs = smem;                  // [BQ][pd]
  float* ks = qs + BQ * pd;          // [BK][pd]
  float* vs = ks + BK * pd;          // [BK][D]
  float* ps = vs + BK * D;           // [BQ][BK + 1] probabilities

  const int nqt = (Sq + BQ - 1) / BQ;
  const int q0 = (nqt - 1 - blockIdx.x) * BQ;   // longest causal rows first
  const int bh = blockIdx.y;
  const long long bi = bh / H, hi = bh % H, hk = hi / (H / Hkv);
  q += bi * sq.b + hi * sq.h;
  k += bi * sk.b + hk * sk.h;
  v += bi * sv.b + hk * sv.h;
  o += bi * so.b + hi * so.h;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    qs[r * pd + c] = q0 + r < Sq ? q[(q0 + r) * sq.s + c] : 0.0f;
  }

  int nkt = (Sk + BK - 1) / BK;
  if (causal) nkt = min(nkt, (q_offset + min(q0 + BQ, Sq) - 1) / BK + 1);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_BIG;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
  }

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                 // the previous tile is no longer read
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < Sk;
      ks[r * pd + c] = in ? k[(k0 + r) * sk.s + c] : 0.0f;
      vs[r * D + c] = in ? v[(k0 + r) * sv.s + c] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float kv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = ks[(tx + 16 * c) * pd + d];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float qv = qs[(ty + 16 * r) * pd + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv, kv[c], s[r][c]);
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q_offset + q0 + ty + 16 * r;
      float mx = NEG_BIG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        float sv = s[r][c] * scale;
        if (kpos >= Sk)
          sv = -INFINITY;
        else if (causal && qpos < kpos)
          sv = NEG_BIG;
        s[r][c] = sv;
        mx = fmaxf(mx, sv);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        ps[(ty + 16 * r) * (BK + 1) + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

    const int kn = min(BK, Sk - k0);
    for (int j = 0; j < kn; ++j) {
      float vv[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < D ? vs[j * D + col] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = ps[(ty + 16 * r) * (BK + 1) + j];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= Sq) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = tx + 16 * c;
      if (col < D) o[row * so.s + col] = acc[r][c] * inv;
    }
    if (lse != nullptr && tx == 0)
      lse[(bi * H + hi) * Sq + row] = m[r] + logf(fmaxf(l[r], 1e-30f));
  }
}


// ------------------------------------------------------------------------- //
// bfloat16: TMA + wgmma
// ------------------------------------------------------------------------- //

constexpr int W_BM = 128;                  // query rows of a block
constexpr int W_BN = 128;                  // keys of a K / V tile
constexpr int W_CONSUMERS = 2;             // warpgroups of 64 query rows
constexpr int W_THREADS = 128 * (W_CONSUMERS + 1);
constexpr int W_BOX = 64;                  // head-dim columns of a TMA box
constexpr int W_BOX_BYTES = 128 * W_BOX * 2;   // [128 rows][64] bf16
constexpr int W_TILE_BYTES = 2 * W_BOX_BYTES;  // d padded to 128
constexpr int W_STAGES = 2;
constexpr int W_SMEM_BYTES = 1024 + W_TILE_BYTES * (1 + 2 * W_STAGES);

// P [64 x 128] of one warpgroup, from the m64n128 accumulator layout (thread
// t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and columns
// 8 j + 2 (t % 4) (+ 1) of d[4 j .. 4 j + 3]), as two bf16 terms: each
// register packs two neighbouring columns, which is the m64k16 A fragment
// of key step kk in registers 4 kk .. 4 kk + 3.
__device__ __forceinline__ void split_p(const float (&p)[64],
                                        uint32_t (&hi)[32],
                                        uint32_t (&lo)[32]) {
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    hi[t] = bf16x2_bits(p[2 * t], p[2 * t + 1]);
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi[t]);
    lo[t] = bf16x2_bits(p[2 * t] - __low2float(h),
                        p[2 * t + 1] - __high2float(h));
  }
}

// KS = ceil(d / 16) k16 steps over the head dimension; the output columns
// split at the TMA box into N1 = min(16 KS, 64) and N2 = 16 KS - N1.
template <int KS>
__global__ void __launch_bounds__(W_THREADS, 1)
flash_kernel_bf16_wgmma(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        __nv_bfloat16* __restrict__ o, Strides so,
                        float* __restrict__ lse, int H, int Hkv, int Sq,
                        int Sk, int D, float scale_log2, float masked_raw,
                        int causal, int q_offset) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * W_STAGES];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t q_full = smem_u32(&bars[0]);
  auto sk = [&](int st) { return base + W_TILE_BYTES * (1 + st); };
  auto sv = [&](int st) { return base + W_TILE_BYTES * (1 + W_STAGES + st); };
  auto full = [&](int st) { return smem_u32(&bars[1 + st]); };
  auto empty = [&](int st) { return smem_u32(&bars[1 + W_STAGES + st]); };

  const int nqt = (Sq + W_BM - 1) / W_BM;
  const int q0 = (nqt - 1 - blockIdx.x) * W_BM;   // longest causal rows first
  const int bh = blockIdx.y;
  const int bi = bh / H, hi = bh % H, hk = hi / (H / Hkv);
  // the kv tile count lives in shared memory, read once per tile: at
  // d = 128 a register held across the loop would spill
  __shared__ int tiles;
  constexpr int N1 = KS * 16 < W_BOX ? KS * 16 : W_BOX;
  constexpr int N2 = KS * 16 - N1;
  constexpr int boxes = N2 > 0 ? 2 : 1;

  if (threadIdx.x == 0) {
    int nkt = (Sk + W_BN - 1) / W_BN;
    if (causal)
      nkt = min(nkt, (q_offset + min(q0 + W_BM, Sq) - 1) / W_BN + 1);
    tiles = nkt;
    mbar_init(q_full, 1);
    for (int st = 0; st < W_STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * W_CONSUMERS);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == W_CONSUMERS) {
    // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * W_CONSUMERS) {
      mbar_expect_tx(q_full, boxes * W_BOX_BYTES);
      for (int bx = 0; bx < boxes; ++bx)
        tma_load(sq + bx * W_BOX_BYTES, &tq, q_full, bx * W_BOX, q0, hi, bi);
      for (int kt = 0; kt < tiles; ++kt) {
        const int st = kt % W_STAGES, fill = kt / W_STAGES;
        if (fill > 0) mbar_wait(empty(st), (fill - 1) & 1);
        mbar_expect_tx(full(st), 2 * boxes * W_BOX_BYTES);
        for (int bx = 0; bx < boxes; ++bx) {
          tma_load(sk(st) + bx * W_BOX_BYTES, &tk, full(st), bx * W_BOX,
                   kt * W_BN, hk, bi);
          tma_load(sv(st) + bx * W_BOX_BYTES, &tv, full(st), bx * W_BOX,
                   kt * W_BN, hk, bi);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wt = threadIdx.x % 128, warp = wt / 32, lane = wt % 32;
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;   // and row0 + 8
    const int col0 = 2 * (lane % 4);
    float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.0f, 0.0f};
    float o0[N1 / 2], o1[N2 > 0 ? N2 / 2 : 1];   // columns 0.. and 64..
#pragma unroll
    for (int i = 0; i < N1 / 2; ++i) o0[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < N2 / 2; ++i) o1[i] = 0.0f;

    mbar_wait(q_full, 0);
    for (int kt = 0; kt < tiles; ++kt) {
      const int st = kt % W_STAGES, fill = kt / W_STAGES;
      const int k0 = kt * W_BN;
      mbar_wait(full(st), fill & 1);

      // S = Q K^T over the head dimension in k16 steps
      float s[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t off = (ks / 4) * W_BOX_BYTES + (ks % 4) * 32;
        wgmma_ss_n128(s, smem_desc(sq + 64 * wg * 128 + off, 16, 1024),
                      smem_desc(sk(st) + off, 16, 1024), ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // online softmax in the log2 domain, float32: the row max is taken
      // over the raw scores and p = 2^(s * scale_log2 - m) is one FFMA and
      // one ex2; a masked raw score is masked_raw = -1e30 / scale_log2
      // (-1e30 once scaled, as in the Pallas kernel; a kernel argument, so
      // it holds no register), a key beyond Sk -inf
      const bool masked = k0 + W_BN > Sk ||
                          (causal && k0 + W_BN - 1 > q_offset + q0 + 64 * wg);
      if (masked) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kpos = k0 + 8 * j + col0 + e;
              float& v = s[4 * j + 2 * h + e];
              if (kpos >= Sk)
                v = -INFINITY;
              else if (causal && q_offset + row0 + 8 * h < kpos)
                v = masked_raw;
            }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mx[h] = fmaxf(mx[h], fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      float alpha[2], neg_m[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h] * scale_log2);
        alpha[h] = ex2(m[h] - m_new);
        m[h] = m_new;
        neg_m[h] = -m_new;
      }
      float rs[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = s[4 * j + 2 * h + e];
            v = ex2(fmaf(v, scale_log2, neg_m[h]));
            rs[h][e] += v;
          }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + (rs[h][0] + rs[h][1]);
#pragma unroll
      for (int i = 0; i < N1 / 2; ++i) o0[i] *= alpha[(i / 2) % 2];
#pragma unroll
      for (int i = 0; i < N2 / 2; ++i) o1[i] *= alpha[(i / 2) % 2];
      uint32_t ph[32], pl[32];
      split_p(s, ph, pl);

      // O += P_hi V + P_lo V over the keys in k16 steps
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t v0 = sv(st) + kk * 16 * 128;
        const uint64_t d0 = smem_desc(v0, 1024, 1024);
        wgmma_rs(o0, ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2],
                 ph[4 * kk + 3], d0);
        wgmma_rs(o0, pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                 pl[4 * kk + 3], d0);
        if constexpr (N2 > 0) {
          const uint64_t d1 = smem_desc(v0 + W_BOX_BYTES, 1024, 1024);
          wgmma_rs(o1, ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2],
                   ph[4 * kk + 3], d1);
          wgmma_rs(o1, pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                   pl[4 * kk + 3], d1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o0);
      if constexpr (N2 > 0) fence_regs(o1);
      if (lane == 0) mbar_arrive(empty(st));
    }

    o += static_cast<long long>(bi) * so.b + static_cast<long long>(hi) * so.h;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = row0 + 8 * h;
      if (row >= Sq) continue;
      const float inv = 1.0f / fmaxf(l[h], 1e-30f);
      // m is in the log2 domain of the scaled scores
      if (lse != nullptr && lane % 4 == 0)
        lse[(static_cast<long long>(bi) * H + hi) * Sq + row] =
            (m[h] + log2f(fmaxf(l[h], 1e-30f))) * 0.69314718055994531f;
      __nv_bfloat16* dst = o + static_cast<long long>(row) * so.s;
#pragma unroll
      for (int j = 0; j < N1 / 8; ++j) {
        const int col = 8 * j + col0;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(o0[4 * j + 2 * h] * inv,
                                    o0[4 * j + 2 * h + 1] * inv);
      }
#pragma unroll
      for (int j = 0; j < N2 / 8; ++j) {
        const int col = W_BOX + 8 * j + col0;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(o1[4 * j + 2 * h] * inv,
                                    o1[4 * j + 2 * h + 1] * inv);
      }
    }
  }
}

int launch_bf16(const void* q, Strides sq, const void* k, Strides sk,
                const void* v, Strides sv, void* o, Strides so, float* lse,
                int B, int H, int Hkv, int Sq, int Sk, int D, float scale,
                int causal, int q_offset, cudaStream_t stream) {
  // what TMA takes: 16-byte aligned bases and byte strides, d % 8 == 0
  if (D % 8 != 0 || B * H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, sq, D, Sq, H, B) ||
      !encode_map(&tk, k, sk, D, Sk, Hkv, B) ||
      !encode_map(&tv, v, sv, D, Sk, Hkv, B))
    return static_cast<int>(cudaErrorInvalidValue);
  static void (*const kernels[8])(CUtensorMap, CUtensorMap, CUtensorMap,
                                  __nv_bfloat16*, Strides, float*, int, int,
                                  int, int, int, float, float, int, int) = {
      flash_kernel_bf16_wgmma<1>, flash_kernel_bf16_wgmma<2>,
      flash_kernel_bf16_wgmma<3>, flash_kernel_bf16_wgmma<4>,
      flash_kernel_bf16_wgmma<5>, flash_kernel_bf16_wgmma<6>,
      flash_kernel_bf16_wgmma<7>, flash_kernel_bf16_wgmma<8>};
  const auto kernel = kernels[(D + 15) / 16 - 1];
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid((Sq + W_BM - 1) / W_BM, B * H);
  kernel<<<grid, W_THREADS, W_SMEM_BYTES, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), so, lse, H, Hkv, Sq, Sk,
      D, scale_log2, NEG_BIG / scale_log2, causal, q_offset);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, Strides sq, const void* k, Strides sk,
               const void* v, Strides sv, void* o, Strides so, float* lse,
               int B, int H, int Hkv, int Sq, int Sk, int D, float scale,
               int causal, int q_offset, cudaStream_t stream) {
  const int bytes = smem_floats(D) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_kernel_f32<<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), sq, static_cast<const float*>(k), sk,
      static_cast<const float*>(v), sv, static_cast<float*>(o), so, lse, H,
      Hkv, Sq, Sk, D, scale, causal, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a call the kernel of that type does not take.
// dtype 0: float32 q, k, v, o (flash_kernel_f32); dtype 1: bfloat16
// (flash_kernel_bf16_wgmma: d % 8 == 0, 16-byte aligned q, k, v and byte
// strides).  q / o are indexed [batch, head, position, d] and k / v
// [batch, kv head, position, d] through the three strides given for each (in
// elements); d has unit stride.  `lse`, when not null, receives the float32
// log-sum-exp of each row's scaled scores, [B, H, Sq] contiguous, as the
// training forward saves it for the backward (flash_attention_bwd.cu); the
// serve path passes null and writes nothing more.  `q_offset` >= 0 is the
// position of query row 0 (a context-parallel shard's first row; 0 for a
// whole sequence).  It comes last, after the stream, so that a library
// built before it took the argument ignores it when called with 0.
extern "C" int flash_attention_launch(
    int dtype, const void* q, long long sq_b, long long sq_h, long long sq_s,
    const void* k, long long sk_b, long long sk_h, long long sk_s,
    const void* v, long long sv_b, long long sv_h, long long sv_s, void* o,
    long long so_b, long long so_h, long long so_s, int B, int H, int Hkv,
    int Sq, int Sk, int D, float scale, int causal, void* lse, void* stream,
    int q_offset) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Sk < 1 ||
      D < 1 || D > DMAX || q_offset < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides q_s{sq_b, sq_h, sq_s}, k_s{sk_b, sk_h, sk_s},
      v_s{sv_b, sv_h, sv_s}, o_s{so_b, so_h, so_s};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* row_lse = static_cast<float*>(lse);
  if (dtype == 0)
    return launch_f32(q, q_s, k, k_s, v, v_s, o, o_s, row_lse, B, H, Hkv, Sq,
                      Sk, D, scale, causal, q_offset, s);
  return launch_bf16(q, q_s, k, k_s, v, v_s, o, o_s, row_lse, B, H, Hkv, Sq,
                     Sk, D, scale, causal, q_offset, s);
}
