// bitlinear: C[M, N] (+)= A[M, K] (int8) @ unpack(B)[K, N], exact int32, for
// a group of independent products in one launch.
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
// What bounds it on an H100: every shape of the serve path (M = 1..24) is
// bound by reading B (3.35 TB/s; the 2-bit layout moves a quarter of the int8
// bytes) or, for the small act-to-act stages, by the launch itself.  The int8
// tensor cores keep the arithmetic below the bytes even at M = 24, where
// __dp4a on the CUDA cores would not.  wgmma is not used: its 64-row tiles buy
// nothing at M <= 24 on products bound by bytes or the launch.
//
// Design:
//   - Swapped operands: the block computes C^T = unpack(B)^T A^T, so output
//     columns n fill the 16-row side of mma.sync m16n8k32 and activation rows
//     m its 8-wide side; M = 1 wastes 7/8 of one narrow fragment, not 15/16 of
//     the weight traffic.  An A register holds 4 consecutive K values of one
//     weight column, which is exactly one byte of the 2-bit packing; it is
//     built in registers from one 32-bit shared-memory word (four
//     neighbouring columns), offset to unsigned bytes and byte-transposed
//     (int8_mma.cuh; the offset is taken back with sum(x) from one more MMA
//     against an all-ones A).  The MMA rows are permuted so that those four
//     columns are rows g, g+8 of two MMAs: one word feeds two MMAs, and no
//     unpacked copy of the weights is ever written.  B registers are 4
//     consecutive bytes of one activation row: aligned 32-bit loads.
//   - One block of 4 warps per [BM = 8 MT, BN = 128] output tile; a warp owns
//     32 columns.  K runs in stages of 64 through a 4-deep ring in shared
//     memory (8 deep measured no faster at bits 2) filled by 16-byte
//     cp.async copies of the packed weight rows (N-contiguous, as stored;
//     16-byte chunks XOR-swizzled so that the fragment reads hit 32
//     distinct banks) and of the activation rows.  Every slot is filled before the first
//     MMA, and each refill goes out one step after its slot was read.
//     Ragged M, N and K edges are zero-filled; sources that are not 16-byte
//     aligned (views at odd offsets) go through registers instead.
//   - Grouped: one launch covers a work list of products (a Legion stage's
//     assignments).  The list travels in the kernel's parameters
//     (__grid_constant__, up to 400 items in 28.8 KB: CUDA >= 12.1 takes
//     32,764 bytes of parameters on sm_90); each block finds its item by
//     binary search over the items' first tiles, as a grouped-GEMM problem
//     visitor does.  A single product is a group of one.
//   - Split-K: when the group has fewer output tiles than two blocks per SM,
//     the K stages of each item split over several blocks (at least
//     MIN_STEPS stages each) whose partial sums are added with integer
//     atomics (exact in any order).  Accumulating calls always add with
//     atomics, so items whose outputs overlap still sum exactly.
#include "int8_mma.cuh"

namespace {

using namespace i8mma;

constexpr int BN = 128;                  // output columns per block (4 warps x 32)
constexpr int BK = 64;                   // K values per pipeline stage
constexpr int STAGES = 4;                // ring depth
constexpr int THREADS = 128;
constexpr int MIN_STEPS = 4;             // K stages a split block runs at least
constexpr int XPITCH = BK + 16;          // bytes per staged activation row (20 words)
constexpr int SMALL = 8, LARGE = 400;    // work-list capacities

struct Item {
  const int8_t* a;
  const uint8_t* b;
  int32_t* c;
  long long lda, ldb, ldc;
  int m, n, k;
  int tile0;                             // first block of this item
  int splits;                            // blocks sharing each output tile's K range
  int flags;                             // 1: A rows 16-byte aligned, 2: B rows
};

template <int CAP>
struct Group {
  Item item[CAP];
  int count;
  int accumulate;
};

template <int BITS, int MT, int CAP>
__global__ void __launch_bounds__(THREADS)
bitlinear_kernel(const __grid_constant__ Group<CAP> g) {
  constexpr int F = 8 / BITS;            // K values per packed byte
  constexpr int WROWS = BK / F;          // packed rows per stage
  constexpr int SH = BITS == 2 ? 0 : (BITS == 4 ? 1 : 2);   // log2 rows per 4 K
  constexpr int BM = 8 * MT;
  __shared__ __align__(128) uint8_t ws[STAGES][WROWS * BN];
  __shared__ __align__(128) uint8_t xs[STAGES][BM * XPITCH];

  // the item whose tiles hold this block
  const int bid = blockIdx.x;
  int lo = 0, hi = g.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (g.item[mid].tile0 <= bid) lo = mid; else hi = mid - 1;
  }
  const Item& it = g.item[lo];
  const int M = it.m, N = it.n, K = it.k;
  const int tiles_m = (M + BM - 1) / BM;
  const int tiles_n = (N + BN - 1) / BN;
  int local = bid - it.tile0;
  const int m0 = (local % tiles_m) * BM;
  local /= tiles_m;
  const int n0 = (local % tiles_n) * BN;
  const int split = local / tiles_n;
  const int chunks = (K + BK - 1) / BK;
  const int per = (chunks + it.splits - 1) / it.splits;
  const int c0 = split * per;
  const int steps = max(min(c0 + per, chunks) - c0, 0);

  const uint8_t* A = reinterpret_cast<const uint8_t*>(it.a);
  const uint8_t* B = it.b;
  const long long lda = it.lda, ldb = it.ldb;
  const bool a16 = it.flags & 1, b16 = it.flags & 2;
  const int kq_total = K / F;

  // constant trip counts, unrolled: a thread's copies all go out before
  // any of them is waited on (which matters on the register path)
  auto load = [&](int slot, int chunk) {
    const int k0 = chunk * BK;
    const int r0 = k0 / F;
#pragma unroll
    for (int j = 0; j < (WROWS * (BN / 16) + THREADS - 1) / THREADS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if (i < WROWS * (BN / 16)) {
        const int r = i / (BN / 16), c = i % (BN / 16);
        const int row = r0 + r, col = n0 + c * 16;
        const int bytes = row < kq_total ? min(max(N - col, 0), 16) : 0;
        const int swizzled = c ^ (((r >> SH) & 3) << 1);
        stage16(&ws[slot][r * BN + swizzled * 16],
                bytes ? B + row * ldb + col : B, bytes, b16);
      }
    }
#pragma unroll
    for (int j = 0; j < (BM * (BK / 16) + THREADS - 1) / THREADS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if (i < BM * (BK / 16)) {
        const int r = i / (BK / 16), c = i % (BK / 16);
        const int m = m0 + r, k = k0 + c * 16;
        const int bytes = m < M ? min(max(K - k, 0), 16) : 0;
        stage16(&xs[slot][r * XPITCH + c * 16], bytes ? A + m * lda + k : A,
                bytes, a16);
      }
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int cw = warp * 8 + gq;          // this thread's word column (4 n)

  // one 32-bit word of packed row r, word column cw, through the swizzle
  auto word = [&](const uint8_t* W, int r) -> uint32_t {
    const int c = (cw >> 2) ^ (((r >> SH) & 3) << 1);
    return *reinterpret_cast<const uint32_t*>(W + r * BN + c * 16 +
                                              (cw & 3) * 4);
  };
  // fragment registers of K group q (K values 4q..4q+3 of a 32-deep step
  // kk) for columns 4 gq + i, i = 0..3
  auto planes = [&](const uint8_t* W, int kk, int q, uint32_t (&r)[4]) {
    if constexpr (BITS == 2) {
      planes_2bit(word(W, kk * 8 + q), r);
    } else if constexpr (BITS == 4) {
      const int row = kk * 16 + 2 * q;
      planes_4bit(word(W, row), word(W, row + 1), r);
    } else {
      const int row = kk * 32 + 4 * q;
      transpose4(word(W, row), word(W, row + 1), word(W, row + 2),
                 word(W, row + 3), r);
    }
  };

  // acc: the products, of offset weights below 8 bits; xsum: sum(x) of
  // each activation row over the block's K range, for the offset's
  // correction (columns 2t, 2t+1 of an all-ones MMA)
  int acc[MT][2][4], xsum[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      acc[i][0][v] = acc[i][1][v] = 0;
      xsum[i][v] = 0;
    }

  // Every slot is filled up front (a split of STAGES stages is in flight
  // whole); each later refill takes the slot consumed one step before, so
  // one barrier a step keeps readers and writers apart.  Copy group g
  // carries stage g: step 0 waits for group 0 of STAGES, step s > 0 for
  // group s of STAGES + s - 1.
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < steps) load(s, c0 + s);
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
      const int refill = step - 1 + STAGES;
      if (refill < steps) load((step - 1) % STAGES, c0 + refill);
      cp_async_commit();
    }
    const uint8_t* W = ws[step % STAGES];
    const uint8_t* X = xs[step % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t lo4[4], hi4[4];
      planes(W, kk, t, lo4);             // K values 4t..4t+3
      planes(W, kk, 4 + t, hi4);         // K values 16+4t..16+4t+3
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint32_t* xr =
            reinterpret_cast<const uint32_t*>(X + (i * 8 + gq) * XPITCH);
        const uint32_t b0 = xr[kk * 8 + t], b1 = xr[kk * 8 + 4 + t];
        // MMA rows g, g+8 are columns 4gq, 4gq+1 (h = 0) or 4gq+2, 4gq+3
        if constexpr (BITS == 8) {
          mma_s8(acc[i][0], lo4[0], lo4[1], hi4[0], hi4[1], b0, b1);
          mma_s8(acc[i][1], lo4[2], lo4[3], hi4[2], hi4[3], b0, b1);
        } else {
          constexpr uint32_t ones = 0x01010101u;
          mma_u8s8(acc[i][0], lo4[0], lo4[1], hi4[0], hi4[1], b0, b1);
          mma_u8s8(acc[i][1], lo4[2], lo4[3], hi4[2], hi4[3], b0, b1);
          mma_u8s8(xsum[i], ones, ones, ones, ones, b0, b1);
        }
      }
    }
  }
  cp_async_wait<0>();

  int32_t* C = it.c;
  const long long ldc = it.ldc;
  const bool accumulate = g.accumulate;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int m = m0 + i * 8 + 2 * t + (v & 1);
        const int n = n0 + warp * 32 + 4 * gq + 2 * h + (v >> 1);
        if (m >= M || n >= N) continue;
        constexpr int offset = BITS == 2 ? 2 : (BITS == 4 ? 8 : 0);
        const int value = acc[i][h][v] - offset * xsum[i][v & 1];
        int32_t* dst = C + m * ldc + n;
        if (accumulate) {
          atomicAdd(dst, value);
        } else {
          *dst = value;
        }
      }
    }
  }
}

template <int BITS, int MT, int CAP>
cudaError_t launch(const Group<CAP>& grp, int blocks, cudaStream_t s) {
  bitlinear_kernel<BITS, MT, CAP><<<blocks, THREADS, 0, s>>>(grp);
  return cudaGetLastError();
}

template <int CAP>
cudaError_t launch_bits(const Group<CAP>& grp, int blocks, int bits, int mt,
                        cudaStream_t s) {
#define BITLINEAR_CASE(B_, MT_) \
  if (bits == B_ && mt == MT_) return launch<B_, MT_, CAP>(grp, blocks, s);
  BITLINEAR_CASE(2, 1) BITLINEAR_CASE(2, 2) BITLINEAR_CASE(2, 4)
  BITLINEAR_CASE(4, 1) BITLINEAR_CASE(4, 2) BITLINEAR_CASE(4, 4)
  BITLINEAR_CASE(8, 1) BITLINEAR_CASE(8, 2) BITLINEAR_CASE(8, 4)
#undef BITLINEAR_CASE
  return cudaErrorInvalidValue;
}

// Fills `grp` with items [first, first + count) of `all`, returns the blocks.
template <int CAP>
int pack(Group<CAP>& grp, const Item* all, int first, int count,
         int accumulate, int bm) {
  int blocks = 0;
  grp.count = 0;
  grp.accumulate = accumulate;
  for (int i = first; i < first + count; ++i) {
    Item it = all[i];
    const int tiles = ((it.m + bm - 1) / bm) * ((it.n + BN - 1) / BN);
    if (tiles == 0) continue;            // an empty product writes nothing
    it.tile0 = blocks;
    blocks += tiles * it.splits;
    grp.item[grp.count++] = it;
  }
  return blocks;
}

}  // namespace

// The grouped entry point.  `desc` holds `count` products of 9 int64 values
// each: A, lda, B, ldb, C, ldc, M, N, K (pointers as integers, strides in
// elements, unit stride along each last axis).  All take the same `bits`.
// accumulate = 1: C += A @ unpack(B) with atomics; accumulate = 0: C = ...
// `sms`: the card's multiprocessors, which sizes the split of K.  Launches
// on `stream`.  Returns the number of kernel launches made (>= 0), or minus
// the CUDA error.
extern "C" int bitlinear_grouped_launch(const long long* desc, int count,
                                        int bits, int accumulate, int sms,
                                        void* stream) {
  if (count < 0 || (bits != 2 && bits != 4 && bits != 8))
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int f = 8 / bits;
  int max_m = 0;
  Item* items = new Item[count > 0 ? count : 1];
  for (int i = 0; i < count; ++i) {
    const long long* d = desc + 9 * i;
    Item& it = items[i];
    it.a = reinterpret_cast<const int8_t*>(d[0]);
    it.lda = d[1];
    it.b = reinterpret_cast<const uint8_t*>(d[2]);
    it.ldb = d[3];
    it.c = reinterpret_cast<int32_t*>(d[4]);
    it.ldc = d[5];
    it.m = static_cast<int>(d[6]);
    it.n = static_cast<int>(d[7]);
    it.k = static_cast<int>(d[8]);
    if (it.m < 0 || it.n < 0 || it.k < 0 || it.k % f) {
      delete[] items;
      return -static_cast<int>(cudaErrorInvalidValue);
    }
    it.flags = ((d[0] % 16 == 0 && it.lda % 16 == 0) ? 1 : 0) |
               ((d[2] % 16 == 0 && it.ldb % 16 == 0) ? 2 : 0);
    max_m = it.m > max_m ? it.m : max_m;
  }
  const int mt = max_m <= 8 ? 1 : (max_m <= 16 ? 2 : 4);
  const int bm = 8 * mt;
  // Split K while the group has fewer tiles than two blocks per SM, down
  // to MIN_STEPS stages per block.  More splits of shorter blocks measured
  // slower on whole stages: each block pays its ring's fill, and at M = 24
  // each restages its activations.
  long long tiles = 0;
  for (int i = 0; i < count; ++i)
    tiles += static_cast<long long>((items[i].m + bm - 1) / bm) *
             ((items[i].n + BN - 1) / BN);
  const long long target = 2LL * (sms > 0 ? sms : 1);
  const int want = tiles > 0 && tiles < target
                       ? static_cast<int>((target + tiles - 1) / tiles) : 1;
  bool zero_first = false;
  for (int i = 0; i < count; ++i) {
    Item& it = items[i];
    const int chunks = (it.k + BK - 1) / BK;
    const int most = (chunks + MIN_STEPS - 1) / MIN_STEPS;
    int splits = want < most ? want : most;
    if (splits < 1) splits = 1;
    const int per = (chunks + splits - 1) / splits;
    it.splits = chunks > 0 ? (chunks + per - 1) / per : 1;
    if (!accumulate && it.splits > 1) zero_first = true;
  }
  if (zero_first) {
    // split partial sums add into C, so a fresh C starts at zero
    for (int i = 0; i < count; ++i) {
      const Item& it = items[i];
      if (it.m == 0 || it.n == 0) continue;
      const cudaError_t e = cudaMemset2DAsync(
          it.c, it.ldc * 4, 0, static_cast<size_t>(it.n) * 4, it.m, s);
      if (e != cudaSuccess) {
        delete[] items;
        return -static_cast<int>(e);
      }
    }
    accumulate = 1;
  }
  int launches = 0;
  cudaError_t err = cudaSuccess;
  if (count <= SMALL) {
    Group<SMALL> grp;
    const int blocks = pack(grp, items, 0, count, accumulate, bm);
    if (blocks > 0) {
      err = launch_bits(grp, blocks, bits, mt, s);
      ++launches;
    }
  } else {
    thread_local Group<LARGE> grp;       // 28.8 KB: off the host stack
    for (int first = 0; first < count && err == cudaSuccess; first += LARGE) {
      const int n = count - first < LARGE ? count - first : LARGE;
      const int blocks = pack(grp, items, first, n, accumulate, bm);
      if (blocks > 0) {
        err = launch_bits(grp, blocks, bits, mt, s);
        ++launches;
      }
    }
  }
  delete[] items;
  return err == cudaSuccess ? launches : -static_cast<int>(err);
}
