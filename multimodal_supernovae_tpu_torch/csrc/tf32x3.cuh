// 3xTF32 tensor-core arithmetic for float32 products (sm_80 and later, used
// on Hopper, sm_90a): the split of a float32 value into two TF32 values, the
// m16n8k8 TF32 mma.sync, the three-product sum that keeps about float32
// accuracy, and fragment loads from float32 tiles in shared memory.
//
// Split. x = hi + lo + r with hi = rna_tf32(x), lo = rna_tf32(x - hi): hi
// keeps the leading 11 significant bits, lo the next 11, and |r| <= 2^-22 |x|
// (x - hi is exact in float32). Then
//   a . b ~= lo_a . hi_b + hi_a . lo_b + hi_a . hi_b
// leaves out lo_a . lo_b (about 2^-22 of the product) and r; the tensor core
// multiplies TF32 values exactly and accumulates in float32. The two small
// terms go first into the accumulator, then hi . hi. One TF32 product alone
// keeps about 11 bits (relative error near 1e-4 on a product of width 64).
//
// Fragment layout of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32,
// with g = lane >> 2 and t = lane & 3 (PTX ISA), one 32-bit register each:
//   A (16 x 8, row, k):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   B (8 x 8, k, col):   b0 (t, g), b1 (t + 4, g);
//   C (16 x 8, float32): c0, c1 (g, 2t .. 2t + 1), c2, c3 (g + 8, 2t .. 2t + 1).
// Unlike bf16 m16n8k16 (csrc/flash_attention_mma.cuh), a C fragment does not
// hold the values an A fragment of the next product needs in the same lanes:
// the fused-FFN kernels take a product's output through shared memory before
// it feeds another. Where the next product sums over the C fragment's
// columns, the flash kernels instead permute that summed index within each
// 8-wide step (csrc/flash_attention_tf32.cuh).
//
// Used by the fused-FFN kernels (csrc/fused_ffn_{fwd,bwd}_mma.cu) and the
// float32 flash-attention kernels (csrc/flash_attention_{fwd,bwd}_tf32.cu).
//
// Shared tiles are float32 (A) or pre-split TF32 bit patterns (B, stored as
// B^T: n rows of k values), row-major with a row stride ld of a multiple of
// 32 floats plus 4. A fragment loads (g, t) then fall on bank 4g + t: the 32
// lanes of a warp hit 32 distinct banks. ldmatrix is built for 16-bit
// elements, so these are plain 32-bit shared loads.
//
// The backward also reads operands stored the other way round, k rows of m
// (or n) values: a weight W (out, in) taken as B = W itself, and the data
// tiles of a weight gradient D^T X, where D (rows x m) is A^T and X (rows x
// n) is B. Those loads take (k0 + t + 4i, m0 + g) and fall on bank 8t + g
// under a row stride of a multiple of 32 floats plus 8 (PAD_KN): again 32
// distinct banks.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tf32x3 {

constexpr int PAD = 4;     // floats of padding a shared row: ld = 32m + PAD
constexpr int PAD_KN = 8;  // the same for tiles stored k rows of m (or n)

// x rounded to TF32, to nearest with ties away from zero (cvt.rna), as bits
// with the 13 low mantissa bits cleared.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

__device__ __forceinline__ float tf32_as_float(uint32_t v) { return __uint_as_float(v); }

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - tf32_as_float(hi));
}

// c += a . b, 16 x 8 x 8, TF32 in, float32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct FragA {  // a 16 x 8 A fragment, split
  uint32_t hi[4], lo[4];
};

struct FragB {  // an 8 x 8 B fragment, split
  uint32_t hi[2], lo[2];
};

// c += a . b in 3xTF32: the two small terms, then hi . hi.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// The A fragment of the 16 x 8 block at (row 0, column k0) of a float32
// row-major shared tile s (ld floats a row), split as it is loaded.
__device__ __forceinline__ void load_a_split(FragA& a, const float* s, int ld, int k0,
                                             int lane) {
  const float* p = s + (lane >> 2) * ld + k0 + (lane & 3);
  split_tf32(p[0], a.hi[0], a.lo[0]);
  split_tf32(p[8 * ld], a.hi[1], a.lo[1]);
  split_tf32(p[4], a.hi[2], a.lo[2]);
  split_tf32(p[8 * ld + 4], a.hi[3], a.lo[3]);
}

// The B fragment of columns n0 .. n0 + 7, depth k0 .. k0 + 7, of B = W^T
// where hi and lo hold W split (n rows of k values, ld a row): b_i = W[n0 +
// g][k0 + t + 4i].
__device__ __forceinline__ void load_b(FragB& b, const uint32_t* hi, const uint32_t* lo,
                                       int ld, int n0, int k0, int lane) {
  const int i = (n0 + (lane >> 2)) * ld + k0 + (lane & 3);
  b.hi[0] = hi[i];
  b.hi[1] = hi[i + 4];
  b.lo[0] = lo[i];
  b.lo[1] = lo[i + 4];
}

// acc (16 x 8 NT, C fragments) += A (16 x K, float32 in shared, lda) . W^T,
// W (8 NT x K) pre-split in shared (hi, lo, ldw): one warp, 3xTF32.
template <int NT, int K>
__device__ __forceinline__ void warp_product(float (&acc)[NT][4], const float* A, int lda,
                                             const uint32_t* hi, const uint32_t* lo, int ldw,
                                             int lane) {
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    FragA a;
    load_a_split(a, A, lda, k0, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      FragB b;
      load_b(b, hi, lo, ldw, 8 * j, k0, lane);
      mma_3xtf32(acc[j], a, b);
    }
  }
}

// The B fragment of columns n0 .. n0 + 7, depth k0 .. k0 + 7, of B = W where
// hi and lo hold W split, k rows of n (ld a row): b_i = W[k0 + t + 4i][n0 + g].
__device__ __forceinline__ void load_b_kn(FragB& b, const uint32_t* hi, const uint32_t* lo,
                                          int ld, int n0, int k0, int lane) {
  const int i = (k0 + (lane & 3)) * ld + n0 + (lane >> 2);
  b.hi[0] = hi[i];
  b.hi[1] = hi[i + 4 * ld];
  b.lo[0] = lo[i];
  b.lo[1] = lo[i + 4 * ld];
}

// The A fragment of rows m0 .. m0 + 15, depth k0 .. k0 + 7, of A = D^T where
// hi and lo hold D split, k rows of m (ld a row): a (r, c) = D[k0 + c][m0 + r].
__device__ __forceinline__ void load_a_kn(FragA& a, const uint32_t* hi, const uint32_t* lo,
                                          int ld, int m0, int k0, int lane) {
  const int i = (k0 + (lane & 3)) * ld + m0 + (lane >> 2);
  a.hi[0] = hi[i];
  a.hi[1] = hi[i + 8];
  a.hi[2] = hi[i + 4 * ld];
  a.hi[3] = hi[i + 4 * ld + 8];
  a.lo[0] = lo[i];
  a.lo[1] = lo[i + 8];
  a.lo[2] = lo[i + 4 * ld];
  a.lo[3] = lo[i + 4 * ld + 8];
}

// acc (16 x 8 NT, C fragments) += A (16 x K, float32 in shared, lda) . W,
// W (K x 8 NT) pre-split in shared, k rows of n (hi, lo, ldw): one warp,
// 3xTF32 (warp_product with B read by load_b_kn).
template <int NT, int K>
__device__ __forceinline__ void warp_product_kn(float (&acc)[NT][4], const float* A, int lda,
                                                const uint32_t* hi, const uint32_t* lo,
                                                int ldw, int lane) {
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    FragA a;
    load_a_split(a, A, lda, k0, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      FragB b;
      load_b_kn(b, hi, lo, ldw, 8 * j, k0, lane);
      mma_3xtf32(acc[j], a, b);
    }
  }
}

// Stage a rows x cols block of a float32 row-major matrix in device memory
// (src, src_ld floats a row) into shared memory split, hi and lo each with ld
// floats a row, by the block's THREADS threads. cols, src_ld, ld and src are
// multiples of 4 floats (16-byte loads and stores).
template <int THREADS>
__device__ __forceinline__ void stage_split(uint32_t* hi, uint32_t* lo, int ld,
                                            const float* __restrict__ src, int64_t src_ld,
                                            int rows, int cols) {
  const int c4 = cols / 4;
  for (int idx = threadIdx.x; idx < rows * c4; idx += THREADS) {
    const int r = idx / c4;
    const int c = (idx - r * c4) * 4;
    const float4 v = __ldg(reinterpret_cast<const float4*>(src + r * src_ld + c));
    uint4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + r * ld + c) = h;
    *reinterpret_cast<uint4*>(lo + r * ld + c) = l;
  }
}

// Sum of v over the four lanes of a quad (the lanes holding one C row).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

}  // namespace tf32x3
