// 3xTF32 tensor-core building blocks shared by csrc/flash_attention_fwd_tf32.cu
// and csrc/flash_attention_bwd_tf32.cu, the float32 flash-attention kernels:
// float32 tiles streamed into shared memory by cp.async and split into TF32
// hi/lo halves once per block, fragment loads from those tiles, and the
// permutation that feeds a product's C fragment to the next product as its A
// fragment without a trip through shared memory.
//
// Fragment layout of mma.sync m16n8k8 .tf32 (csrc/tf32x3.cuh), with g = lane
// >> 2 and t = lane & 3:
//   A (16 x 8):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   B (8 x 8):   b0 (k t, column g), b1 (k t + 4, column g);
//   C (16 x 8):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// A C fragment's lane holds columns 2t and 2t + 1; an A fragment's lane wants
// columns t and t + 4. Where the next product sums over those columns (P . V
// sums over keys, dS . K over keys, P^T . g and dS^T . q over queries), the
// summed index may be relabelled within each 8-wide step: A column t stands
// for column 2t, A column t + 4 for 2t + 1. Then a = (c0, c2, c1, c3), and
// the B fragment reads rows 2t and 2t + 1 of the step to match (c_to_a_perm,
// load_b_perm).
//
// Two tile layouts, one for each way a product reads a streamed tile:
//   * row tiles: TILE rows of S floats at a row stride of S + 4, the TF32 hi
//     halves in one tile, the lo halves in another. A product that takes the
//     tile's rows as its 8 columns and the head dim as k (Q . K^T) reads a
//     B fragment, (row n0 + g, columns k0 + t and k0 + t + 4) of hi and of
//     lo, with one ldmatrix.x4: four 8 x 4-word matrices, 8 rows of 16 bytes
//     each, whose rows start on 16-byte chunks 3r (S = 8), 5r (S = 16), 9r
//     (S = 32) or 17r (S = 64) mod 8, 8 distinct chunks;
//   * transposed tiles: for each head-dim column, the (hi, lo) pairs of the
//     TILE rows in row order, a column RT = 2 TILE + 16 words apart. A
//     product that sums over the tile's rows (P . V) reads its B fragment,
//     rows r0 + 2t and r0 + 2t + 1 at column n0 + g, hi and lo, as one
//     16-byte load: the 8 lanes of a quarter warp (g = 0, 1) fall on chunks
//     t + c and 4 + t + c mod 8, 8 distinct chunks.
//
// Split once: thread tid copies and splits the 16-byte chunks of row tid %
// TILE, column chunks tid / TILE + 2i (issue_rows, split_chunks). After its
// cp.async copies land it rewrites them as TF32 hi halves in place (row
// tiles), with the lo halves in a second tile, and/or writes the transposed
// pairs, scaling (k * c) or shifting (v - v0) first; a thread sees its own
// completed copies without a barrier. The block's four warps then read
// pre-split B fragments and never split a shared value again; only the A
// side (a warp's own rows, and P or dS from registers) is split per warp.
// The cp.async targets (hi tiles, raw tiles) are double-buffered; the lo and
// transposed tiles, written after the barrier that ends the previous tile's
// compute, are single.

#pragma once

#include "flash_attention_mma.cuh"
#include "tf32x3.cuh"

namespace flash_tf32 {

// the tile shape, the cp.async and key-kind helpers of the bf16 kernels
using namespace flash_mma;
using tf32x3::FragA;
using tf32x3::FragB;
using tf32x3::mma_tf32;
using tf32x3::split_tf32;

static_assert(THREADS == 2 * TILE, "two threads a tile row");

template <int S>
struct LayoutF {
  static_assert(S == 8 || S == 16 || S == 32 || S == 64,
                "3xTF32 flash kernels take head dims 8, 16, 32 and 64");
  static constexpr int RS = S + 4;          // row tiles: floats a row
  static constexpr int TS = TILE * RS;      // words a row tile
  static constexpr int RT = 2 * TILE + 16;  // transposed tiles: words a column
  static constexpr int TT = S * RT;         // words a transposed tile
  static constexpr int CH = S / 8;          // 16-byte chunks a thread copies
};

// The cp.async target tiles of each streamed side: two (double-buffered)
// where a second tile follows the first, one at T <= TILE (the ViT's T = 36),
// whose smaller dynamic shared memory leaves an SM room for another block
// (a second at head dim 64, a fourth at 32). The kernels lay their tiles out
// by it at run time and launch_dyn asks for that much.
__host__ __device__ __forceinline__ int raw_buffers(int T_len) { return T_len > TILE ? 2 : 1; }

// Thread tid's row of a tile and its i-th column chunk.
__device__ __forceinline__ int own_row(int tid) { return tid % TILE; }
__device__ __forceinline__ int own_chunk(int tid, int i) { return tid / TILE + 2 * i; }

// Issue the asynchronous copies of this thread's chunks of rows r0 .. r0 +
// TILE - 1 of a (T, S) float32 matrix (row stride st) into the row tile dst;
// rows at or past T are zero-filled.
template <int S>
__device__ __forceinline__ void issue_rows(uint32_t* dst, const float* x, int64_t st, int r0,
                                           int T_len, int tid) {
  const int r = own_row(tid), src = r0 + r;
  const bool full = src < T_len;
  const float* from = x + (full ? src : 0) * st;
#pragma unroll
  for (int i = 0; i < LayoutF<S>::CH; ++i) {
    const int c = own_chunk(tid, i);
    cp_async_16(dst + r * LayoutF<S>::RS + 4 * c, from + 4 * c, full);
  }
}

// This thread's column chunks of row 0 of a (T, S) float32 matrix with
// 16-byte rows: the shift split_chunks takes off (v - v0), held in
// registers.
template <int S>
__device__ __forceinline__ void own_chunks_of_row0(float4 (&v0)[LayoutF<S>::CH], const float* y,
                                                   int tid) {
#pragma unroll
  for (int i = 0; i < LayoutF<S>::CH; ++i)
    v0[i] = *reinterpret_cast<const float4*>(y + 4 * own_chunk(tid, i));
}

// After cp_async_wait: split this thread's chunks of the row tile raw as x *
// scale - shift_of(i, c) (chunk i of the thread, column chunk c): into hi
// halves in place and lo halves in lo when lo is not null, and into (hi, lo)
// pairs of the transposed tile tr when tr is not null. The barrier that
// follows publishes the split tiles to the block.
template <int S, typename ShiftOf>
__device__ __forceinline__ void split_chunks_by(uint32_t* raw, uint32_t* lo, uint32_t* tr,
                                                float scale, ShiftOf shift_of, int tid) {
  using L = LayoutF<S>;
  const int r = own_row(tid);
#pragma unroll
  for (int i = 0; i < L::CH; ++i) {
    const int c = own_chunk(tid, i);
    const int off = r * L::RS + 4 * c;
    float4 v = *reinterpret_cast<const float4*>(raw + off);
    const float4 sh = shift_of(i, c);
    v.x = v.x * scale - sh.x;
    v.y = v.y * scale - sh.y;
    v.z = v.z * scale - sh.z;
    v.w = v.w * scale - sh.w;
    uint4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    if (lo != nullptr) {
      *reinterpret_cast<uint4*>(raw + off) = h;
      *reinterpret_cast<uint4*>(lo + off) = l;
    }
    if (tr != nullptr) {
      uint32_t* p = tr + (4 * c) * L::RT + 2 * r;
      *reinterpret_cast<uint2*>(p) = make_uint2(h.x, l.x);
      *reinterpret_cast<uint2*>(p + L::RT) = make_uint2(h.y, l.y);
      *reinterpret_cast<uint2*>(p + 2 * L::RT) = make_uint2(h.z, l.z);
      *reinterpret_cast<uint2*>(p + 3 * L::RT) = make_uint2(h.w, l.w);
    }
  }
}

// split_chunks_by with no shift, or the shift held in registers
// (own_chunks_of_row0).
template <int S>
__device__ __forceinline__ void split_chunks(uint32_t* raw, uint32_t* lo, uint32_t* tr,
                                             float scale, int tid) {
  split_chunks_by<S>(raw, lo, tr, scale, [](int, int) { return make_float4(0.f, 0.f, 0.f, 0.f); },
                     tid);
}

template <int S>
__device__ __forceinline__ void split_chunks(uint32_t* raw, uint32_t* lo, uint32_t* tr,
                                             float scale, const float4 (&shift)[LayoutF<S>::CH],
                                             int tid) {
  split_chunks_by<S>(raw, lo, tr, scale, [&](int i, int) { return shift[i]; }, tid);
}

// The same with the shift read from row 0 of a (T, S) float32 matrix in
// device memory (16-byte rows) at each split rather than held in registers
// across the tile loop: the 3xTF32 dq kernel at head dim 64, whose registers
// are short (S / 2 of them).
template <int S>
__device__ __forceinline__ void split_chunks(uint32_t* raw, uint32_t* lo, uint32_t* tr,
                                             float scale, const float* shift, int tid) {
  split_chunks_by<S>(
      raw, lo, tr, scale,
      [=](int, int c) { return __ldg(reinterpret_cast<const float4*>(shift + 4 * c)); }, tid);
}

// The float32 values of an A fragment's places, k-step by k-step, of rows
// row0 .. row0 + 15 of a (T, S) matrix in device memory (row stride st):
// x[ks] = (row g, column 8ks + t), (g + 8, 8ks + t), (g, 8ks + t + 4),
// (g + 8, 8ks + t + 4). Rows at or past T read as zero.
template <int S>
__device__ __forceinline__ void load_rows(float (&x)[S / 8][4], const float* p, int64_t st,
                                          int row0, int T_len, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < S / 8; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e & 1);
      x[ks][e] = row < T_len ? p[row * st + 8 * ks + t + 4 * (e >> 1)] : 0.f;
    }
  }
}

__device__ __forceinline__ void split_a(FragA& a, const float (&x)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(x[e], a.hi[e], a.lo[e]);
}

// The B fragment of a product whose 8 columns are row-tile rows n0 .. n0 + 7
// and whose k runs over the head dim k0 .. k0 + 7: b_i = X[n0 + g][k0 + t +
// 4i] (Q . K^T with K's rows as columns), hi and lo by one ldmatrix.x4.
template <int S>
__device__ __forceinline__ void load_b_rows(FragB& b, const uint32_t* hi, const uint32_t* lo,
                                            int n0, int k0, int lane) {
  const int j = lane >> 3;  // matrices: hi at k0, hi at k0 + 4, lo at k0, lo at k0 + 4
  uint32_t r[4];
  ldsm_x4(r, ((j & 2) ? lo : hi) + (n0 + (lane & 7)) * LayoutF<S>::RS + k0 + 4 * (j & 1));
  b.hi[0] = r[0];
  b.hi[1] = r[1];
  b.lo[0] = r[2];
  b.lo[1] = r[3];
}

// A warp's own 16 x S A side kept split in shared memory rather than in
// registers (hi and lo tiles of 16 rows at the row-tile stride RS): the
// 3xTF32 kernels at S = 64, whose two A sides as registers (2 x 64 a lane)
// beside their accumulators would pass the 255 a thread may hold. The lane's
// places of each k-step (row g + 8 (e & 1), column 8 ks + t + 4 (e >> 1)) are
// stored once; store_a_smem's banks (4g + t + 8 ks) mod 32 are 32 distinct.
template <int S>
__device__ __forceinline__ void store_a_smem(uint32_t* hi, uint32_t* lo, const FragA& a, int ks,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int off = (g + 8 * (e & 1)) * LayoutF<S>::RS + 8 * ks + t + 4 * (e >> 1);
    hi[off] = a.hi[e];
    lo[off] = a.lo[e];
  }
}

// The split A fragment of k-step ks from those tiles by two ldmatrix.x4 (hi,
// lo): matrix j of each is rows 8 (j & 1) .., columns 8 ks + 4 (j >> 1) ..,
// whose (g, t) word is a_j; rows start on chunks 17r mod 8, 8 distinct.
template <int S>
__device__ __forceinline__ void load_a_smem(FragA& a, const uint32_t* hi, const uint32_t* lo,
                                            int ks, int lane) {
  const int j = lane >> 3;
  const int off = (8 * (j & 1) + (lane & 7)) * LayoutF<S>::RS + 8 * ks + 4 * (j >> 1);
  ldsm_x4(a.hi, hi + off);
  ldsm_x4(a.lo, lo + off);
}

// The B fragment of a product whose k runs over tile rows r0 .. r0 + 7 in the
// permuted order and whose 8 columns are the head dim n0 .. n0 + 7: b0 =
// X[r0 + 2t][n0 + g], b1 = X[r0 + 2t + 1][n0 + g] (P . V with V's rows as k),
// hi and lo by one 16-byte load from the transposed tile.
template <int S>
__device__ __forceinline__ void load_b_perm(FragB& b, const uint32_t* tr, int r0, int n0,
                                            int lane) {
  const uint4 w = *reinterpret_cast<const uint4*>(
      tr + (n0 + (lane >> 2)) * LayoutF<S>::RT + 2 * (r0 + 2 * (lane & 3)));
  b.hi[0] = w.x;
  b.lo[0] = w.y;
  b.hi[1] = w.z;
  b.lo[1] = w.w;
}

// The A fragment, split, of a 16 x 8 C fragment taken with its columns in the
// permuted order: a = (c0, c2, c1, c3).
__device__ __forceinline__ void c_to_a_perm(FragA& a, const float (&c)[4]) {
  split_tf32(c[0], a.hi[0], a.lo[0]);
  split_tf32(c[2], a.hi[1], a.lo[1]);
  split_tf32(c[1], a.hi[2], a.lo[2]);
  split_tf32(c[3], a.hi[3], a.lo[3]);
}

// c = A . B over the head dim from zero, 3xTF32: A's S/8 k-steps against
// row-tile rows n0 .. n0 + 7 (load_b_rows), each pass in its own accumulator
// (independent chains of S/8 products), summed on the CUDA cores as
// hi . hi + (lo . hi + hi . lo).
template <int S>
__device__ __forceinline__ void mma_head(float (&c)[4], const FragA (&a)[S / 8],
                                         const uint32_t* hi, const uint32_t* lo, int n0,
                                         int lane) {
  float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
  c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < S / 8; ++ks) {
    FragB b;
    load_b_rows<S>(b, hi, lo, n0, 8 * ks, lane);
    mma_tf32(c0, a[ks].lo, b.hi);
    mma_tf32(c1, a[ks].hi, b.lo);
    mma_tf32(c, a[ks].hi, b.hi);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += c0[e] + c1[e];
}

// mma_head with the A side read from a warp's shared hi and lo tiles
// (load_a_smem) at each k-step.
template <int S>
__device__ __forceinline__ void mma_head_smem(float (&c)[4], const uint32_t* ahi,
                                              const uint32_t* alo, const uint32_t* hi,
                                              const uint32_t* lo, int n0, int lane) {
  float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
  c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < S / 8; ++ks) {
    FragA a;
    load_a_smem<S>(a, ahi, alo, ks, lane);
    FragB b;
    load_b_rows<S>(b, hi, lo, n0, 8 * ks, lane);
    mma_tf32(c0, a.lo, b.hi);
    mma_tf32(c1, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += c0[e] + c1[e];
}

// acc[n] += C . X over tile rows r0 .. r0 + 7, C one 16 x 8 C fragment
// (c_to_a_perm), X's S columns in 8-wide steps n (load_b_perm from the
// transposed tile). The step's three passes each go into a zero accumulator
// and their sum is added to acc on the CUDA cores, in float32 rounded to
// nearest: these sums run over every key (or query), and the tensor core's
// own float32 accumulation, chained over them, puts the outputs about 10x
// farther from the plain version at T = 1024 (normalised 7.2e-6 against
// 5.7e-7) and dv on nearly equal values 3x the plain version's distance to
// float64 (probe_flash_tf32.py, variant "chained"; NVIDIA H100 80GB HBM3 at
// 700 W), for 5-9% less time.
template <int S>
__device__ __forceinline__ void mma_rows(float (&acc)[S / 8][4], const float (&c)[4],
                                         const uint32_t* tr, int r0, int lane) {
  FragA a;
  c_to_a_perm(a, c);
#pragma unroll
  for (int n = 0; n < S / 8; ++n) {
    FragB b;
    load_b_perm<S>(b, tr, r0, 8 * n, lane);
    float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
    float c2[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(c0, a.lo, b.hi);
    mma_tf32(c1, a.hi, b.lo);
    mma_tf32(c2, a.hi, b.hi);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += c2[e] + (c0[e] + c1[e]);
  }
}

// Write rows row0 + g and row0 + g + 8 of a 16 x S C-fragment accumulator,
// times mul, to a (T, S) float32 matrix (row stride st); rows at or past T
// are skipped.
template <int S>
__device__ __forceinline__ void store_rows(float* p, int64_t st, const float (&acc)[S / 8][4],
                                           float mul, int row0, int T_len, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= T_len) continue;
#pragma unroll
    for (int n = 0; n < S / 8; ++n) {
      *reinterpret_cast<float2*>(p + row * st + 8 * n + 2 * t) =
          make_float2(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
    }
  }
}

// Launch a kernel with dyn bytes of dynamic shared memory (over the 48 KB a
// launch may take without asking).
template <typename K, typename... A>
cudaError_t launch_dyn(K kernel, dim3 grid, int dyn, cudaStream_t stream, const A&... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, dyn, stream>>>(args...);
  return cudaGetLastError();
}

// Whether a (T, S) float32 tensor's rows can be copied 16 bytes at a time.
__host__ __forceinline__ bool rows_aligned_f32(const void* p, int64_t sb, int64_t sh,
                                               int64_t st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 4 == 0 && sh % 4 == 0 &&
         st % 4 == 0;
}

// Whether float2 stores into a (T, S) float32 tensor are aligned.
__host__ __forceinline__ bool pairs_aligned_f32(const void* p, int64_t sb, int64_t sh,
                                                int64_t st) {
  return reinterpret_cast<uintptr_t>(p) % 8 == 0 && sb % 2 == 0 && sh % 2 == 0 &&
         st % 2 == 0;
}

}  // namespace flash_tf32
