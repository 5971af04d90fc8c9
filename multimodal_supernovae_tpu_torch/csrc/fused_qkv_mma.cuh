// Tensor-core building blocks shared by csrc/fused_qkv_fwd_mma.cu and
// csrc/fused_qkv_bwd_mma.cu, on top of csrc/flash_attention_mma.cuh (its
// mma.sync products, ldmatrix loads and fragment layouts, which that file's
// header describes): the staging of the float32 weights as bf16, the loads of
// whole-sample row buffers, the A fragments of a warp's 16 rows, the product
// of a row tile with a staged weight, the mask's key kinds and the block-wide
// products that sum a weight gradient over a sample's rows.
//
// Layout. One block works on one sample at a time, T <= 256 positions padded
// to Tp = ceil16(T) rows; warp w owns rows 16w .. 16w + 15 (16 warps cover
// 256). Whole-sample buffers are (Tp, E) bf16 in shared memory with rows of
// RS = E + 8 elements: at E = 32 (80-byte rows) and E = 64 (144-byte rows)
// the 8 rows that one ldmatrix phase reads start on 8 distinct 16-byte bank
// groups, so no ldmatrix has a bank conflict. Staged weights use the same row
// stride. Rows at or past T are zero.

#pragma once

#include "flash_attention_mma.cuh"
#include "fused_qkv_common.cuh"

namespace qkv_mma {

using flash_mma::bf16;
using flash_mma::c_to_a;
using flash_mma::cp_async_16;
using flash_mma::cp_async_commit;
using flash_mma::cp_async_wait;
using flash_mma::exp2_approx;
using flash_mma::key_kind;
using flash_mma::ldsm_cols;
using flash_mma::ldsm_rows;
using flash_mma::ldsm_x2;
using flash_mma::ldsm_x4;
using flash_mma::ldsm_x4_trans;
using flash_mma::LOG2E;
using flash_mma::MASK_FILL_LOG2;
using flash_mma::mma_head;
using flash_mma::mma_k16;
using flash_mma::pack_bf16;
using flash_mma::quad_max;
using flash_mma::quad_sum;

constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_T = 16 * WARPS;  // one 16-row tile a warp

template <int E>
struct Dims {
  static_assert(E == 32 || E == 64, "the tensor-core fused-QKV kernels take E = 32 and 64");
  static constexpr int RS = E + 8;  // row stride of every (rows, E) buffer, elements
};

__host__ __device__ constexpr int pad16(int t) { return (t + 15) & ~15; }

// dst[r][c] = bf16(W[r][c]) for a row-major float32 (rows, E) W, rows of rs
// elements: exactly torch's W.to(bfloat16) (round to nearest even). W is
// 16-byte aligned; each thread converts four floats at a time.
template <int E>
__device__ __forceinline__ void stage_weight(bf16* dst, const float* __restrict__ W, int rows,
                                             int tid) {
  for (int i = tid; i < rows * E / 4; i += THREADS) {
    const float4 w = reinterpret_cast<const float4*>(W)[i];
    const int r = i / (E / 4), c = 4 * (i % (E / 4));
    *reinterpret_cast<uint2*>(dst + r * Dims<E>::RS + c) =
        make_uint2(pack_bf16(w.x, w.y), pack_bf16(w.z, w.w));
  }
}

// Issue the asynchronous copies of a (T, E) bf16 row block src into the
// (Tp, E) buffer dst, 16 bytes a copy; rows T .. Tp - 1 are zero-filled.
template <int E>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src, int T_len, int tid) {
  constexpr int CPR = E / 8;  // 16-byte chunks a row
  const int n = pad16(T_len) * CPR;
  for (int i = tid; i < n; i += THREADS) {
    const int r = i / CPR, c = 8 * (i % CPR);
    const bool full = r < T_len;
    cp_async_16(dst + r * Dims<E>::RS + c, src + (full ? r * E + c : 0), full);
  }
}

// Each key's kind (flash_mma::key_kind: 0 valid, 1 masked, 2 at or past T)
// for keys 0 .. Tp - 1.
__device__ __forceinline__ void write_kinds(uint8_t* kind, const uint8_t* mask_row, int T_len,
                                            int tid) {
  if (tid < pad16(T_len)) kind[tid] = key_kind(mask_row, tid, T_len);
}

// A score in the log2 domain after the mask: valid keys keep s * log2(e),
// masked keys get the fill -1e7 (times log2 e), keys past T drop out.
__device__ __forceinline__ float masked_log2(float s, uint8_t kind) {
  return kind == 0 ? s * LOG2E : (kind == 1 ? MASK_FILL_LOG2 : -INFINITY);
}

// The A fragment (16 x 16) of rows 0 .. 15 of a buffer with row stride rs,
// columns 0 .. 15 from base: ldmatrix, no transpose.
__device__ __forceinline__ void ldsm_a16(uint32_t (&a)[4], const bf16* base, int rs, int lane) {
  ldsm_x4(a, base + (lane & 15) * rs + 8 * (lane >> 4));
}

// The A fragment (16 x S) of a head: rows 0 .. 15, S columns from base.
template <int S>
__device__ __forceinline__ void ldsm_a_head(uint32_t (&a)[S / 4], const bf16* base, int rs,
                                            int lane) {
  if constexpr (S == 16) {
    ldsm_a16(a, base, rs, lane);
  } else {
    uint32_t r[2];
    ldsm_x2(r, base + (lane & 15) * rs);
    a[0] = r[0];
    a[1] = r[1];
  }
}

// The A fragment (16 m x 16 k) of a transposed operand: memory rows are k
// (0 .. 15 from base, stride rs), memory columns m (0 .. 15 from base).
__device__ __forceinline__ void ldsm_a16_t(uint32_t (&a)[4], const bf16* base, int rs,
                                           int lane) {
  ldsm_x4_trans(a, base + ((lane & 7) + 8 * (lane >> 4)) * rs + 8 * ((lane >> 3) & 1));
}

// The A fragments of a warp's 16 rows over all E columns of a row buffer.
template <int E>
__device__ __forceinline__ void load_row_tile(uint32_t (&a)[E / 16][4], const bf16* rows,
                                              int lane) {
#pragma unroll
  for (int kk = 0; kk < E / 16; ++kk) ldsm_a16(a[kk], rows + 16 * kk, Dims<E>::RS, lane);
}

// Products of 16 rows (A fragment a, 16 x S) with rows 16 c .. 16 c + 15 of
// a head's (rows, S) columns at cols (row stride rs), the head dim as k: two
// 16 x 8 C tiles (q . k^T, datt_h . v^T and their transposes).
template <int S>
__device__ __forceinline__ void head_product(float (&s)[2][4], const uint32_t (&a)[S / 4],
                                             const bf16* cols, int rs, int c, int lane) {
  uint32_t f[2][S / 8];
  ldsm_rows<S>(f, cols, 16 * c, lane, rs);
#pragma unroll
  for (int i = 0; i < 2; ++i) mma_head<S>(s[i], a, f[i]);
}

// c = rows . W^T for 16 output columns: a is a row tile's A fragments over K,
// w points at 16 rows of a staged (out, in) weight (row stride Dims<K>::RS),
// c[i] the 16 x 8 float32 tile of output columns 8i .. 8i + 7.
template <int K>
__device__ __forceinline__ void tile_x_wt(float (&c)[2][4], const uint32_t (&a)[K / 16][4],
                                          const bf16* w, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t b[2][2];
    ldsm_rows<16>(b, w + 16 * kk, 0, lane, Dims<K>::RS);
#pragma unroll
    for (int i = 0; i < 2; ++i) mma_k16(c[i], a[kk], b[i][0], b[i][1]);
  }
}

// c += A . W for 16 output columns n0 .. n0 + 15, where W's memory rows are
// the contraction (row stride rs): A's fragment for k16 step kk is a[kk].
template <int KT>
__device__ __forceinline__ void tile_x_w(float (&c)[2][4], const uint32_t (&a)[KT][4],
                                         const bf16* w, int rs, int lane) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t b[2][2];
    ldsm_cols<16>(b, w, 16 * kk, lane, rs);
#pragma unroll
    for (int i = 0; i < 2; ++i) mma_k16(c[i], a[kk], b[i][0], b[i][1]);
  }
}

// Store a 16 x 8 float32 C tile, rounded to bf16, into rows row0 + g and
// row0 + g + 8 of a buffer with row stride rs (column 2t of the tile at col).
__device__ __forceinline__ void store_c(bf16* buf, int rs, int col, const float (&c)[4],
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
  *reinterpret_cast<uint32_t*>(buf + g * rs + col + 2 * t) = pack_bf16(c[0], c[1]);
  *reinterpret_cast<uint32_t*>(buf + (g + 8) * rs + col + 2 * t) = pack_bf16(c[2], c[3]);
}

// acc[u] += sum over the sample's rows of A^T . B, block-wide: output tile u
// of this warp is (m-tile mt, n-tiles 2np, 2np + 1) with unit = warp + WARPS u,
// mt = unit / NP, np = unit % NP, over MT * NP units. A's columns m come from
// PARTS buffers of E columns each (m-tile mt in part mt / (E / 16)), B's
// columns n from one buffer; both have rows of Dims<E>::RS and Tp rows, zero
// past T. Used for dWqkv = dqkv^T x (3 parts) and dWu = g^T att (1 part).
template <int E, int PARTS, int UNITS>
__device__ __forceinline__ void sum_at_b(float (&acc)[UNITS][2][4],
                                         const bf16* const (&parts)[PARTS], const bf16* B,
                                         int Tp, int warp, int lane) {
  constexpr int RS = Dims<E>::RS, MT = PARTS * E / 16, NP = E / 16;
  static_assert(UNITS * WARPS >= MT * NP, "every output tile has a warp");
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    const int unit = warp + WARPS * u;
    if (unit >= MT * NP) break;
    const int mt = unit / NP, np = unit % NP;
    const bf16* A = parts[mt / (E / 16)] + 16 * (mt % (E / 16));
#pragma unroll 4
    for (int k0 = 0; k0 < Tp; k0 += 16) {
      uint32_t a[4], b[2][2];
      ldsm_a16_t(a, A + k0 * RS, RS, lane);
      ldsm_cols<16>(b, B + 16 * np, k0, lane, RS);
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_k16(acc[u][i], a, b[i][0], b[i][1]);
    }
  }
}

// Write this warp's tiles of sum_at_b into a row-major float32 (MT*16, E)
// gradient dst.
template <int E, int PARTS, int UNITS>
__device__ __forceinline__ void store_sum(float* dst, const float (&acc)[UNITS][2][4],
                                          int warp, int lane) {
  constexpr int MT = PARTS * E / 16, NP = E / 16;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    const int unit = warp + WARPS * u;
    if (unit >= MT * NP) break;
    const int mt = unit / NP, np = unit % NP;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<float2*>(dst + (16 * mt + g + 8 * r) * E + 16 * np + 8 * i + 2 * t) =
            make_float2(acc[u][i][2 * r], acc[u][i][2 * r + 1]);
      }
    }
  }
}

}  // namespace qkv_mma
