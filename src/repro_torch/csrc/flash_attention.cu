// flash_attention: online-softmax attention, causal or full, with GQA.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention/kernel.py.  That Pallas kernel walks a
// grid (b*h, q tile, kv tile) whose kv axis runs in order and carries the
// running max m, sum l and accumulator acc in VMEM scratch; a BlockSpec index
// map points each query head at its KV head (h / (H / Hkv)), and kv tiles
// wholly in the causal future are skipped.  Here one block per (q tile,
// b*h) walks the kv tiles itself, in ascending order up to the causal
// limit, and keeps m and l in registers (each row's 16 threads hold copies)
// and acc in registers.  Scores, m, l and acc are float32, products are
// float32 FMA; the output is acc / max(l, 1e-30) in q's type (float32 or
// bfloat16).  Masked scores take -1e30 as in the Pallas kernel, and since kv
// tile 0 always comes first every real row meets an unmasked score before a
// fully masked tile, so exp(s - m) of a masked score is 0.  Keys beyond Sk
// (a ragged last tile) take -inf and add nothing.  The causal mask is the
// Pallas kernel's top-left one, q position >= k position, also when
// Sq != Sk.
//
// q, k, v and o are read through (batch, head, position) strides with unit
// stride along the head dimension, so [B, S, H, d] tensors and their
// [B, H, S, d] transposes both go in uncopied.  Head dimension d <= 128 at run
// time (Zamba2-7B's is 112).
//
// What bounds it on an H100: at Zamba2-7B's long-prompt prefill (B = 1,
// H = Hkv = 32, S = 4096, d = 112, causal) the two products take ~1.2e11
// FLOP against ~117 MB of q, k, v and o in bf16: 0.12 ms at the bf16
// tensor-core peak, 1.8 ms at the float32 CUDA-core rate this first version
// uses (it computes from shared memory with 4 x 4 score and 4 x 8
// accumulator register tiles per thread).  Tensor cores (mma / wgmma on bf16
// tiles), TMA loads and double buffering are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // 16 x 16
constexpr int BQ = 64;         // query rows of a block: ty + 16 r, r < 4
constexpr int BK = 64;         // keys of a kv tile: tx + 16 c, c < 4
constexpr int DMAX = 128;      // accumulator columns tx + 16 c, c < 8
constexpr float NEG_BIG = -1e30f;

struct Strides {
  long long b, h, s;           // elements between batches, heads, positions
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__host__ __device__ inline int smem_floats(int d) {
  return 2 * BQ * (d + 1) + BK * d + BQ * (BK + 1);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, Strides sq, const T* __restrict__ k,
             Strides sk, const T* __restrict__ v, Strides sv,
             T* __restrict__ o, Strides so, int H, int Hkv, int Sq, int Sk,
             int D, float scale, int causal) {
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
    qs[r * pd + c] = q0 + r < Sq ? load(q + (q0 + r) * sq.s + c) : 0.0f;
  }

  int nkt = (Sk + BK - 1) / BK;
  if (causal) nkt = min(nkt, (min(q0 + BQ, Sq) - 1) / BK + 1);

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
      ks[r * pd + c] = in ? load(k + (k0 + r) * sk.s + c) : 0.0f;
      vs[r * D + c] = in ? load(v + (k0 + r) * sv.s + c) : 0.0f;
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
      const int qpos = q0 + ty + 16 * r;
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
      if (col < D) store(o + row * so.s + col, acc[r][c] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, Strides sq, const void* k, Strides sk,
           const void* v, Strides sv, void* o, Strides so, int B, int H,
           int Hkv, int Sq, int Sk, int D, float scale, int causal,
           cudaStream_t stream) {
  const int bytes = smem_floats(D) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_kernel<T><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), sq, static_cast<const T*>(k), sk,
      static_cast<const T*>(v), sv, static_cast<T*>(o), so, H, Hkv, Sq, Sk,
      D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// dtype 0: float32 q, k, v, o; dtype 1: bfloat16.  q / o are indexed
// [batch, head, position, d] and k / v [batch, kv head, position, d] through
// the three strides given for each (in elements); d has unit stride.
extern "C" int flash_attention_launch(
    int dtype, const void* q, long long sq_b, long long sq_h, long long sq_s,
    const void* k, long long sk_b, long long sk_h, long long sk_s,
    const void* v, long long sv_b, long long sv_h, long long sv_s, void* o,
    long long so_b, long long so_h, long long so_s, int B, int H, int Hkv,
    int Sq, int Sk, int D, float scale, int causal, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Sk < 1 ||
      D < 1 || D > DMAX || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides q_s{sq_b, sq_h, sq_s}, k_s{sk_b, sk_h, sk_s},
      v_s{sv_b, sv_h, sv_s}, o_s{so_b, so_h, so_s};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, q_s, k, k_s, v, v_s, o, o_s, B, H, Hkv, Sq, Sk,
                         D, scale, causal, s);
  return launch<__nv_bfloat16>(q, q_s, k, k_s, v, v_s, o, o_s, B, H, Hkv, Sq,
                               Sk, D, scale, causal, s);
}
