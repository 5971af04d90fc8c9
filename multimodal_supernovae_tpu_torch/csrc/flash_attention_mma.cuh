// Tensor-core building blocks shared by csrc/flash_attention_fwd_mma.cu and
// csrc/flash_attention_bwd_mma.cu: cp.async tile loads, ldmatrix fragment
// loads, bf16 mma.sync products with float32 accumulation, and the tile
// layout both kernels use.
//
// Fragment layouts (PTX ISA, mma.sync m16n8k16 / m16n8k8 with .bf16 inputs),
// with g = lane / 4 and t = lane % 4:
//   A (16 x K, row-major), one 32-bit register per (row half, k half):
//     a[2*kh + r] holds rows g + 8r, columns 8kh + 2t and 8kh + 2t + 1;
//   B (K x 8), one register per k half: b[kh] holds k = 8kh + 2t, 8kh + 2t + 1
//     of column g;
//   C (16 x 8 float32): c[2r + i] is row g + 8r, column 2t + i.
// So the C fragments of two adjacent 8-column tiles, rounded to bf16 and
// packed in pairs, are the A fragment of an m16n8k16 whose k runs over those
// 16 columns: the flash kernels feed P (and dS) from one product to the next
// without a trip through shared memory.
//
// Shared tiles hold TILE rows of a (T, S) bf16 matrix. At S = 16 a row is
// padded from 32 to 48 bytes: the 8 rows one ldmatrix phase reads then start
// in 8 distinct groups of 4 banks (32-byte rows would put rows r and r + 4 on
// the same banks, a 2-way conflict). At S = 32 a row is padded from 64 to 80
// bytes for the same reason (row r starts on 16-byte chunk 5r mod 8), at S =
// 64 from 128 to 144 (chunk 9r mod 8). At S = 8 the 16-byte rows of a phase
// are contiguous and conflict-free already. Both the forward and the backward
// kernels take S = 8, 16, 32 and 64.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace flash_mma {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;  // rows a block owns: 16 a warp
constexpr int TILE = 64;          // rows of the streamed side per shared tile
static_assert(TILE <= THREADS, "one staged row (mask byte, row residual) a thread");
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK_FILL_LOG2 = -1e7f * LOG2E;

template <int S>
struct Layout {
  static_assert(S == 8 || S == 16 || S == 32 || S == 64,
                "tensor-core flash kernels take head dims 8, 16, 32 and 64");
  static constexpr int RS = S == 8 ? 8 : S + 8;  // shared row stride, elements
  static constexpr int CPR = S / 8;            // 16-byte chunks a row
};

// (b, h, t) element strides of one (B, H, T, S) tensor; S is contiguous.
struct Strides {
  int64_t b, h, t;
  __device__ __forceinline__ int64_t at(int b_, int h_, int t_) const {
    return b_ * b + h_ * h + t_ * this->t;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !full (the
// source is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a . b, 16 x 8 x 16, bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_k16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = A . B over the head dim, from a zero accumulator: A is a 16 x S
// fragment, B the S x 8 fragment of 8 shared rows taken as columns
// (S / 16 chained m16n8k16 at S = 32 and 64, one at S = 16, m16n8k8 at S = 8).
template <int S>
__device__ __forceinline__ void mma_head(float (&c)[4], const uint32_t (&a)[S / 4],
                                         const uint32_t (&b)[S / 8]) {
  const float z = 0.f;
  if constexpr (S >= 32) {
    c[0] = c[1] = c[2] = c[3] = z;
#pragma unroll
    for (int kh = 0; kh < S / 16; ++kh) {
      const uint32_t ak[4] = {a[4 * kh], a[4 * kh + 1], a[4 * kh + 2], a[4 * kh + 3]};
      mma_k16(c, ak, b[2 * kh], b[2 * kh + 1]);
    }
  } else if constexpr (S == 16) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(z));
  } else {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5}, {%6}, {%7, %7, %7, %7};\n"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(b[0]), "f"(z));
  }
}

// lo in the low half, as mma operands and memory order want it.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}

// round(x * c) of two packed bf16 values, as the plain version's bf16(q * c).
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t w, float c) {
  const float2 f = unpack_bf16(w);
  return pack_bf16(f.x * c, f.y * c);
}

// 2^x on the MUFU pipe; -inf gives +0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// max and sum over the 2 NJ values of one row (r = 0: row g, 1: row g + 8)
// in a thread's NJ C fragments (NJ a power of 2), as trees (depth log2 2 NJ,
// not a chain).
template <int NJ>
__device__ __forceinline__ float row_max(const float (&s)[NJ][4], int r) {
  float m[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) m[j] = fmaxf(s[j][2 * r], s[j][2 * r + 1]);
#pragma unroll
  for (int w = NJ / 2; w > 0; w >>= 1) {
#pragma unroll
    for (int j = 0; j < w; ++j) m[j] = fmaxf(m[j], m[j + w]);
  }
  return m[0];
}

template <int NJ>
__device__ __forceinline__ float row_sum(const float (&s)[NJ][4], int r) {
  float m[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) m[j] = s[j][2 * r] + s[j][2 * r + 1];
#pragma unroll
  for (int w = NJ / 2; w > 0; w >>= 1) {
#pragma unroll
    for (int j = 0; j < w; ++j) m[j] += m[j + w];
  }
  return m[0];
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The A fragment (16 x S) of rows row0 .. row0 + 15 of a (T, S) matrix in
// device memory, with row stride st; rows at or past T read as zero. With
// scale != 1 each element is rounded to bf16(x * scale).
template <int S>
__device__ __forceinline__ void load_a(uint32_t (&a)[S / 4], const bf16* x, int64_t st,
                                       int row0, int T_len, float scale, bool scaled,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kh = 0; kh < S / 8; ++kh) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      uint32_t w = 0;
      if (row < T_len) w = *reinterpret_cast<const uint32_t*>(x + row * st + 8 * kh + 2 * t);
      a[2 * kh + r] = scaled ? scale_bf16x2(w, scale) : w;
    }
  }
}

// Issue the asynchronous copies of rows r0 .. r0 + TILE - 1 of two (T, S)
// matrices x and y (row strides sx, sy) into the shared tiles xs and ys; rows
// at or past T are zero-filled. Thread tid copies chunks tid, tid + THREADS,
// ... of the 2 * TILE * CPR chunks, x's first: the same chunks of xs that
// scale_own_chunks later rescales.
template <int S>
__device__ __forceinline__ void issue_tile(bf16* xs, bf16* ys, const bf16* x, const bf16* y,
                                           int64_t sx, int64_t sy, int r0, int T_len,
                                           int tid) {
  using L = Layout<S>;
  constexpr int N = TILE * L::CPR;
  static_assert(2 * N % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < 2 * N / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const bool second = c >= N;
    const int w = second ? c - N : c;
    const int row = w / L::CPR, ch = w % L::CPR;
    const int src = r0 + row;
    const bool full = src < T_len;
    const bf16* from = second ? y + (full ? src : 0) * sy : x + (full ? src : 0) * sx;
    cp_async_16((second ? ys : xs) + row * L::RS + 8 * ch, from + 8 * ch, full);
  }
}

// After cp_async_wait: round this thread's own chunks of xs to bf16(x * scale)
// in place. A thread sees its own completed copies without a barrier; the
// barrier that follows publishes the scaled tile to the block.
template <int S>
__device__ __forceinline__ void scale_own_chunks(bf16* xs, float scale, int tid) {
  using L = Layout<S>;
  constexpr int N = TILE * L::CPR;
  static_assert(N <= THREADS || N % THREADS == 0, "whole chunks of xs a thread");
#pragma unroll
  for (int c = tid; c < N; c += THREADS) {
    uint4* p = reinterpret_cast<uint4*>(xs + (c / L::CPR) * L::RS + 8 * (c % L::CPR));
    uint4 w = *p;
    w.x = scale_bf16x2(w.x, scale);
    w.y = scale_bf16x2(w.y, scale);
    w.z = scale_bf16x2(w.z, scale);
    w.w = scale_bf16x2(w.w, scale);
    *p = w;
  }
}

// B fragments of shared rows r0 .. r0 + 15 taken as the 16 columns of two
// 8-column tiles (b[i] for rows r0 + 8i ..), the head dim as k: S . rows^T.
// rs is the row stride in elements (a tile's by default; the fused-QKV
// kernels pass their wider rows, with tile pointing at a head's columns).
template <int S>
__device__ __forceinline__ void ldsm_rows(uint32_t (&b)[2][S / 8], const bf16* tile, int r0,
                                          int lane, int rs = Layout<S>::RS) {
  if constexpr (S >= 16) {  // one ldmatrix.x4 a 16 columns of the head dim
#pragma unroll
    for (int kh = 0; kh < S / 16; ++kh) {
      uint32_t r[4];
      ldsm_x4(r, tile + (r0 + ((lane >> 4) << 3) + (lane & 7)) * rs + 16 * kh +
                     8 * ((lane >> 3) & 1));
      b[0][2 * kh] = r[0];
      b[0][2 * kh + 1] = r[1];
      b[1][2 * kh] = r[2];
      b[1][2 * kh + 1] = r[3];
    }
  } else {
    uint32_t r[2];
    ldsm_x2(r, tile + (r0 + (lane & 15)) * rs);
    b[0][0] = r[0];
    b[1][0] = r[1];
  }
}

// B fragments of shared rows r0 .. r0 + 15 as the k = 16 of a product whose
// 8-column tiles n run over the head dim (b[n] = {k 0-7, k 8-15}): P . rows.
// rs as for ldsm_rows.
template <int S>
__device__ __forceinline__ void ldsm_cols(uint32_t (&b)[S / 8][2], const bf16* tile, int r0,
                                          int lane, int rs = Layout<S>::RS) {
  if constexpr (S >= 16) {  // one ldmatrix.x4.trans a 16 columns of the head dim
#pragma unroll
    for (int nh = 0; nh < S / 16; ++nh) {
      uint32_t r[4];
      ldsm_x4_trans(r, tile + (r0 + (lane & 15)) * rs + 16 * nh + 8 * (lane >> 4));
      b[2 * nh][0] = r[0];
      b[2 * nh][1] = r[1];
      b[2 * nh + 1][0] = r[2];
      b[2 * nh + 1][1] = r[3];
    }
  } else {
    uint32_t r[2];
    ldsm_x2_trans(r, tile + (r0 + (lane & 15)) * rs);
    b[0][0] = r[0];
    b[0][1] = r[1];
  }
}

// The A fragment (16 x 16) of two 16 x 8 float32 C fragments side by side,
// rounded to bf16: columns 0-7 from c0, 8-15 from c1.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// A key's kind: 0 valid, 1 masked (score set to -1e7), 2 at or past T; in two
// halves, so that for a key of the next tile the mask byte is read at the top
// of an iteration and turned into the kind after its compute, and the read's
// latency hides behind the tile's work instead of stalling it.
__device__ __forceinline__ uint8_t mask_byte(const uint8_t* mask_row, int key, int T_len) {
  return mask_row != nullptr && key < T_len ? mask_row[key] : 1;
}

__device__ __forceinline__ uint8_t kind_of(uint8_t byte, int key, int T_len) {
  return key >= T_len ? 2 : byte ? 0 : 1;
}

__device__ __forceinline__ uint8_t key_kind(const uint8_t* mask_row, int key, int T_len) {
  return kind_of(mask_byte(mask_row, key, T_len), key, T_len);
}

// Whether a (T, S) bf16 tensor's rows can be copied 16 bytes at a time.
__host__ __forceinline__ bool rows_aligned(const void* p, int64_t sb, int64_t sh, int64_t st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 && sh % 8 == 0 && st % 8 == 0;
}

}  // namespace flash_mma
