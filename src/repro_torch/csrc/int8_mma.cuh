// int8_mma.cuh: the int8 tensor-core pieces that bitlinear.cu and
// block_sparse.cu share.
//
// Both kernels multiply with mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
// (u8.s8 for offset sub-byte weights, below) and stage their operands
// through a ring of 16-byte cp.async copies.  The
// fragment layout (PTX ISA, "Matrix Fragments for mma.m16n8k32", 8-bit
// types), with g = lane / 4 and t = lane % 4:
//
//   A (16 x 32, row):  a0 = row g,     cols 4t..4t+3     a1 = row g + 8, cols 4t..4t+3
//                      a2 = row g,     cols 16+4t..+3    a3 = row g + 8, cols 16+4t..+3
//   B (32 x 8, col):   b0 = rows 4t..4t+3, col g         b1 = rows 16+4t..+3, col g
//   C (16 x 8, s32):   c0, c1 = row g, cols 2t, 2t+1     c2, c3 = row g + 8, same cols
//
// Each 32-bit A or B register holds four consecutive K values of one row
// (A) or column (B), the lowest K in the lowest byte.  The operand that is
// stored N-contiguous (the weights) reaches that form through a 4 x 4 byte
// transpose of four 32-bit words (transpose4), each word four neighbouring
// columns of one K row; 2- and 4-bit fields are offset to unsigned bytes in
// place first (planes_2bit / planes_4bit).  Nothing here is a library GEMM:
// only the PTX instructions themselves.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace i8mma {

// 16-byte global -> shared copy that skips L1.  Reads `bytes` (0..16) from
// `gmem`, zero-fills the rest; both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The same 16 bytes for a source that is not 16-byte aligned (a strided
// view at an odd offset): byte loads through registers, zero-filled.
__device__ __forceinline__ void copy16_bytes(void* smem, const uint8_t* gmem,
                                             int bytes) {
  unsigned long long lo = 0, hi = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i < bytes) lo |= static_cast<unsigned long long>(gmem[i]) << (8 * i);
    if (i + 8 < bytes)
      hi |= static_cast<unsigned long long>(gmem[i + 8]) << (8 * i);
  }
  *reinterpret_cast<ulonglong2*>(smem) = make_ulonglong2(lo, hi);
}

// One 16-byte staging copy: asynchronous where the source is aligned,
// through registers otherwise (visible after the ring's __syncthreads).
// A chunk wholly outside the operand (a padding row of a narrow M tile, a
// column past N) is a plain store of zeros: a zero-byte cp.async still
// sends a request, and those of every block would queue at one address.
__device__ __forceinline__ void stage16(void* smem, const uint8_t* gmem,
                                        int bytes, bool aligned) {
  if (bytes == 0) {
    *reinterpret_cast<uint4*>(smem) = make_uint4(0u, 0u, 0u, 0u);
  } else if (aligned) {
    cp_async16(smem, gmem, bytes);
  } else {
    copy16_bytes(smem, gmem, bytes);
  }
}

// d += a * b over one m16n8k32 tile, exact in int32.
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// r[i] byte j = p_j byte i: four K rows of four columns in, four columns of
// four K values (one fragment register each) out.
__device__ __forceinline__ void transpose4(uint32_t p0, uint32_t p1,
                                           uint32_t p2, uint32_t p3,
                                           uint32_t (&r)[4]) {
  const uint32_t t0 = __byte_perm(p0, p1, 0x5140);   // a0 b0 a1 b1
  const uint32_t t1 = __byte_perm(p0, p1, 0x7362);   // a2 b2 a3 b3
  const uint32_t t2 = __byte_perm(p2, p3, 0x5140);   // c0 d0 c1 d1
  const uint32_t t3 = __byte_perm(p2, p3, 0x7362);   // c2 d2 c3 d3
  r[0] = __byte_perm(t0, t2, 0x5410);                // a0 b0 c0 d0
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}

// d += a * b over one m16n8k32 tile with A unsigned (u8) and B signed.
__device__ __forceinline__ void mma_u8s8(int (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Sub-byte weights enter the MMA offset, as unsigned bytes: a 2-bit two's
// complement field f holds w = (f ^ 2) - 2 and a 4-bit one w = (f ^ 8) - 8,
// so u = f ^ 2 (f ^ 8) is one mask-and-xor per word, no sign extension,
// and sum(w x) = sum(u x) - 2 sum(x) (- 8 sum(x)).  The kernels take
// sum(x) from one more MMA with an all-ones A.

// One word of the 2-bit K-major packing (byte i: rows 4k'..4k'+3 of column
// i, row 4k'+j at bits 2j) -> fragment registers r[i] = the four offset K
// values u of column i.
__device__ __forceinline__ void planes_2bit(uint32_t w, uint32_t (&r)[4]) {
  constexpr uint32_t m = 0x03030303u, o = 0x02020202u;
  transpose4((w & m) ^ o, ((w >> 2) & m) ^ o, ((w >> 4) & m) ^ o,
             ((w >> 6) & m) ^ o, r);
}

// Two words of the 4-bit K-major packing, rows 2k' (w0: rows 4q, 4q+1) and
// 2k' + 1 (w1: rows 4q+2, 4q+3), low nibble first -> r[i] as above.
__device__ __forceinline__ void planes_4bit(uint32_t w0, uint32_t w1,
                                            uint32_t (&r)[4]) {
  constexpr uint32_t m = 0x0F0F0F0Fu, o = 0x08080808u;
  transpose4((w0 & m) ^ o, ((w0 >> 4) & m) ^ o, (w1 & m) ^ o,
             ((w1 >> 4) & m) ^ o, r);
}

}  // namespace i8mma
