// Shared device code of csrc/fused_ffn_fwd.cu and csrc/fused_ffn_bwd.cu: the
// row tile, dtype rounding, a CUDA-core tile product with the weight staged in
// shared memory chunk by chunk, warp reductions, and the column sums and outer
// products the backward accumulates its parameter gradients with.
//
// A block of THREADS threads owns a tile of ROWS rows; warp w owns rows
// w*RPW .. w*RPW+RPW-1 of it in every product and every row pass, so a value a
// warp keeps for its rows (a row's rstd) stays with that warp. All row buffers
// are float32 in dynamic shared memory and hold values already rounded to the
// compute dtype T where the JAX kernel rounds.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace ffn {

constexpr int ROWS = 32;                    // rows per block tile
constexpr int THREADS = 256;                // 8 warps
constexpr int RPW = ROWS / (THREADS / 32);  // rows per warp: 4
constexpr int KC = 32;                      // contraction depth of a staged chunk
constexpr int MAX_COLS = 256;               // output columns of one product pass
constexpr int WS_LD = MAX_COLS + 1;         // staged chunk row: +1 against bank conflicts
constexpr int MAX_EJ = 8;                   // E / 32 per lane in a row pass: E <= 256

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round through the compute dtype (the identity for float).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage the KC x (32*NC) chunk (k0.., o0..) of a float32 weight, rounded to T,
// into Ws[kk * WS_LD + oo]. OUT_IN: W is (O, K) row-major (a Linear weight;
// the product is a @ W^T); otherwise W is (K, O) row-major (a @ W).
template <typename T, int NC, bool OUT_IN>
__device__ __forceinline__ void stage(const float* __restrict__ W, int K, int O, int k0,
                                      int o0, float* Ws) {
  constexpr int COLS = 32 * NC;
  for (int idx = threadIdx.x; idx < KC * COLS; idx += THREADS) {
    int kk, oo;
    float w;
    if (OUT_IN) {  // neighbouring threads on neighbouring k: coalesced reads
      kk = idx % KC;
      oo = idx / KC;
      w = W[(int64_t)(o0 + oo) * K + k0 + kk];
    } else {
      oo = idx % COLS;
      kk = idx / COLS;
      w = W[(int64_t)(k0 + kk) * O + o0 + oo];
    }
    Ws[kk * WS_LD + oo] = round_to<T>(w);
  }
}

// acc = sum over k < K of A[r][k] * B[k][o] for each of the warp's RPW rows r
// and the lane's columns o = o0 + lane + 32 j (j < NC), float32 accumulation;
// then epi(r, o, acc). A is a shared-memory row buffer of lda floats a row;
// B comes from W (see stage). Starts with a __syncthreads, so the caller's
// writes to A are visible; the caller syncs before reading what epi wrote.
template <typename T, int NC, bool OUT_IN, typename Epi>
__device__ __forceinline__ void gemm_pass(const float* A, int lda, int K,
                                          const float* __restrict__ W, int O, int o0,
                                          float* Ws, Epi& epi) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* Aw = A + warp * RPW * lda;
  float acc[RPW][NC];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // A is written and the previous chunk consumed
    stage<T, NC, OUT_IN>(W, K, O, k0, o0, Ws);
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < KC; kk += 4) {
      float4 a[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        a[i] = *reinterpret_cast<const float4*>(Aw + i * lda + k0 + kk);  // broadcast
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float* b = Ws + kk * WS_LD + lane + 32 * j;
        const float b0 = b[0], b1 = b[WS_LD], b2 = b[2 * WS_LD], b3 = b[3 * WS_LD];
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          acc[i][j] = fmaf(a[i].x, b0, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b1, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b2, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b3, acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) epi(warp * RPW + i, o0 + lane + 32 * j, acc[i][j]);
}

// The tile product over all O columns, in passes of at most MAX_COLS.
template <typename T, bool OUT_IN, typename Epi>
__device__ void gemm(const float* A, int lda, int K, const float* __restrict__ W, int O,
                     float* Ws, Epi epi) {
  for (int o0 = 0; o0 < O; o0 += MAX_COLS) {
    switch (min(O - o0, MAX_COLS) / 32) {
      case 1: gemm_pass<T, 1, OUT_IN>(A, lda, K, W, O, o0, Ws, epi); break;
      case 2: gemm_pass<T, 2, OUT_IN>(A, lda, K, W, O, o0, Ws, epi); break;
      case 3: gemm_pass<T, 3, OUT_IN>(A, lda, K, W, O, o0, Ws, epi); break;
      case 4: gemm_pass<T, 4, OUT_IN>(A, lda, K, W, O, o0, Ws, epi); break;
      case 5: gemm_pass<T, 5, OUT_IN>(A, lda, K, W, O, o0, Ws, epi); break;
      case 6: gemm_pass<T, 6, OUT_IN>(A, lda, K, W, O, o0, Ws, epi); break;
      case 7: gemm_pass<T, 7, OUT_IN>(A, lda, K, W, O, o0, Ws, epi); break;
      default: gemm_pass<T, 8, OUT_IN>(A, lda, K, W, O, o0, Ws, epi); break;
    }
  }
}

// LayerNorm statistics of the warp's row i (E floats at row): float32, the
// E[x^2] - E[x]^2 form, no clamp (the JAX kernel's _layernorm_rows). Loads the
// lane's columns into v and returns (mean, rstd).
__device__ __forceinline__ float2 ln_stats(const float* row, int E, float eps,
                                           float (&v)[MAX_EJ]) {
  const int lane = threadIdx.x & 31;
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_EJ; ++j) {
    if (32 * j < E) {
      v[j] = row[lane + 32 * j];
      s += v[j];
      ss += v[j] * v[j];
    }
  }
  const float mean = warp_sum(s) / E;
  const float var = warp_sum(ss) / E - mean * mean;
  return make_float2(mean, rsqrtf(var + eps));
}

}  // namespace ffn
