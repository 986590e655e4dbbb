// bitlinear: C[M, N] (+)= A[M, K] (int8) @ unpack(B)[K, N], exact int32.
//
// Replaces the TPU kernel `_bitlinear_kernel` / `bitlinear_matmul` of
// src/repro/kernels/bitlinear/kernel.py (a Pallas kernel that unpacks the
// K-major packed weights in VMEM and carries an int32 accumulator across a K
// grid axis).  Here the K loop runs inside each block, and B is read as
// stored:
//
//   bits = 2: byte (k', n) holds rows 4k'..4k'+3 of column n, row 4k'+i at
//             bit 2i, two's complement (-2 is legal);
//   bits = 4: byte (k', n) holds rows 2k', 2k'+1 (low nibble first);
//   bits = 8: B is plain int8 [K, N] (the W8 / act-to-act dense path).
//
// What bounds it on an H100: at decode (M = 1..4) every packed weight byte is
// used M times, so the kernel is bound by reading B from device memory
// (3.35 TB/s); the 2-bit layout moves a quarter of the int8 bytes.  At
// prefill (M = tens of rows) the int8 multiply-adds grow with M while the
// bytes do not; the ceiling there is the int8 tensor-core rate, which this
// first version does not reach: it multiplies with __dp4a on the CUDA cores.
//
// Design: one block of 256 threads per [BM=16, BN=64] output tile.  Each step
// of the K loop stages BK=128 values of A and the matching packed rows of B
// in shared memory, unpacking and sign-extending B to int8 on the way, stored
// K-contiguous per column so that one 32-bit word feeds one __dp4a (for
// 2-bit weights one packed byte is exactly one such word).  Ragged M, N and K
// edges are masked with zeros; leading-dimension strides are passed in, so
// strided tile views of a larger matrix need no copy.  When the caller asks
// to accumulate into C, the K range may be split over gridDim.z blocks that
// add their partial sums with integer atomics (exact in any order), which
// gives a decode GEMV of a narrow tile enough blocks to keep loads in flight.
// wgmma, TMA and multi-stage pipelining are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;
constexpr int BN = 64;
constexpr int BK = 128;
constexpr int THREADS = 256;
constexpr int PITCH = BK + 4;            // bytes per smem row: 33 words, no bank conflicts
constexpr int WPITCH = PITCH / 4;

__device__ __forceinline__ int8_t field(uint32_t byte, int bits, int i) {
  const int v = (byte >> (bits * i)) & ((1 << bits) - 1);
  const int sign = 1 << (bits - 1);
  return static_cast<int8_t>((v ^ sign) - sign);
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
bitlinear_kernel(const int8_t* __restrict__ A, long long lda,
                 const uint8_t* __restrict__ B, long long ldb,
                 int32_t* __restrict__ C, long long ldc,
                 int M, int N, int K, int accumulate, int chunks_per_split) {
  constexpr int F = 8 / BITS;            // K values per packed byte
  constexpr int BKQ = BK / F;            // packed rows per K step
  __shared__ __align__(16) int8_t xs[BM * PITCH];
  __shared__ __align__(16) int8_t ws[BN * PITCH];   // [n][k], K-contiguous

  const int tid = threadIdx.x;
  const int tx = tid % 16;               // output columns tx + 16 j
  const int ty = tid / 16;               // output row
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int kq_total = K / F;
  const int chunk0 = blockIdx.z * chunks_per_split;
  const int chunk1 = min(chunk0 + chunks_per_split, (K + BK - 1) / BK);

  int acc[4] = {0, 0, 0, 0};
  const int* xw = reinterpret_cast<const int*>(xs);
  const int* ww = reinterpret_cast<const int*>(ws);

  for (int chunk = chunk0; chunk < chunk1; ++chunk) {
    const int k0 = chunk * BK;
    const int kq0 = k0 / F;
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK, c = idx % BK;
      const int m = m0 + r, k = k0 + c;
      xs[r * PITCH + c] = (m < M && k < K) ? A[m * lda + k] : int8_t(0);
    }
    for (int idx = tid; idx < BKQ * BN; idx += THREADS) {
      const int r = idx / BN, c = idx % BN;
      const int n = n0 + c, kq = kq0 + r;
      const uint32_t byte = (n < N && kq < kq_total) ? B[kq * ldb + n] : 0u;
#pragma unroll
      for (int i = 0; i < F; ++i) {
        ws[c * PITCH + r * F + i] = BITS == 8 ? static_cast<int8_t>(byte)
                                              : field(byte, BITS, i);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kw = 0; kw < BK / 4; ++kw) {
      const int a = xw[ty * WPITCH + kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j] = __dp4a(a, ww[(tx + 16 * j) * WPITCH + kw], acc[j]);
      }
    }
    __syncthreads();
  }

  const int m = m0 + ty;
  if (m >= M) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= N) continue;
    int32_t* dst = C + m * ldc + n;
    if (!accumulate) {
      *dst = acc[j];
    } else if (gridDim.z > 1) {
      atomicAdd(dst, acc[j]);
    } else {
      *dst += acc[j];
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// accumulate = 0: C = A @ B (C fully overwritten, splits must be 1);
// accumulate = 1: C += A @ B, the K chunks of BK split over `splits` blocks.
extern "C" int bitlinear_launch(const void* A, long long lda, const void* B,
                                long long ldb, void* C, long long ldc, int M,
                                int N, int K, int bits, int accumulate,
                                int splits, void* stream) {
  const int chunks = (K + BK - 1) / BK;
  if (splits < 1) splits = 1;
  if (splits > chunks) splits = chunks > 0 ? chunks : 1;
  const int per = (chunks + splits - 1) / splits;
  splits = chunks > 0 ? (chunks + per - 1) / per : 1;
  if (!accumulate && splits != 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int8_t*>(A);
  auto b = static_cast<const uint8_t*>(B);
  auto c = static_cast<int32_t*>(C);
  switch (bits) {
    case 2:
      bitlinear_kernel<2><<<grid, THREADS, 0, s>>>(a, lda, b, ldb, c, ldc, M, N, K, accumulate, per);
      break;
    case 4:
      bitlinear_kernel<4><<<grid, THREADS, 0, s>>>(a, lda, b, ldb, c, ldc, M, N, K, accumulate, per);
      break;
    case 8:
      bitlinear_kernel<8><<<grid, THREADS, 0, s>>>(a, lda, b, ldb, c, ldc, M, N, K, accumulate, per);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
