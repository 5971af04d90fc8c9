// Shared device code of csrc/fused_qkv_fwd.cu and csrc/fused_qkv_bwd.cu: dtype
// rounding, the staging of a weight slice in shared memory, the product of a
// thread's row with the staged slice, and head-dim dot products.
//
// One block works on one sample and thread t owns sequence position t in every
// row-local step (T <= THREADS), so nothing but the staged weights and the
// attention itself crosses threads. All shared-memory buffers are float32 and
// hold values already rounded to the compute dtype T where the JAX kernel
// rounds. Per-head buffers are (T, S) with no padding (rows 16-byte aligned for
// the float4 broadcast reads of the attention loops); whole-sample buffers are
// (T, E + 1), the odd row length keeping the threads' own-row reads off one
// bank.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace qkv {

constexpr int THREADS = 256;  // one thread per sequence position: T <= 256
constexpr int EC = 32;        // output columns of one pass over E
constexpr float MASK_FILL = -1e7f;

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

// Stage a K x N slice of a float32 row-major weight W (ldw floats a row),
// rounded to T, as Ws[k * N + n]. K_IS_ROW: Ws[k][n] = W[r0 + k][c0 + n] (the
// contraction runs over W's rows); otherwise Ws[k][n] = W[r0 + n][c0 + k] (W
// is a Linear's (out, in) and the product is a @ W^T).
template <typename T, bool K_IS_ROW>
__device__ __forceinline__ void stage(const float* __restrict__ W, int ldw, int r0, int c0,
                                      int K, int N, float* Ws) {
  for (int idx = threadIdx.x; idx < K * N; idx += THREADS) {
    int k, n;
    float w;
    if (K_IS_ROW) {  // neighbouring threads on neighbouring n: coalesced reads
      n = idx % N;
      k = idx / N;
      w = W[(int64_t)(r0 + k) * ldw + c0 + n];
    } else {  // neighbouring threads on neighbouring k
      k = idx % K;
      n = idx / K;
      w = W[(int64_t)(r0 + n) * ldw + c0 + k];
    }
    Ws[k * N + n] = round_to<T>(w);
  }
}

// acc[n] = sum over k < K of a[k] * Ws[k * N + n], float32 accumulation: the
// thread's row a (shared-memory floats or device-memory T) times the staged
// slice, read as float4 broadcasts.
template <int N, typename A>
__device__ __forceinline__ void row_dot(const A* a, int K, const float* Ws, float (&acc)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = 0.f;
  for (int k = 0; k < K; ++k) {
    const float av = to_float(a[k]);
    const float4* w = reinterpret_cast<const float4*>(Ws + k * N);
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float4 wv = w[j];
      acc[4 * j + 0] = fmaf(av, wv.x, acc[4 * j + 0]);
      acc[4 * j + 1] = fmaf(av, wv.y, acc[4 * j + 1]);
      acc[4 * j + 2] = fmaf(av, wv.z, acc[4 * j + 2]);
      acc[4 * j + 3] = fmaf(av, wv.w, acc[4 * j + 3]);
    }
  }
}

// Load S floats of a 16-byte aligned shared-memory row.
template <int S>
__device__ __forceinline__ void load_row(const float* row, float (&r)[S]) {
#pragma unroll
  for (int j = 0; j < S / 4; ++j) {
    const float4 v = reinterpret_cast<const float4*>(row)[j];
    r[4 * j + 0] = v.x;
    r[4 * j + 1] = v.y;
    r[4 * j + 2] = v.z;
    r[4 * j + 3] = v.w;
  }
}

template <int S>
__device__ __forceinline__ float dot(const float (&a)[S], const float (&b)[S]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < S; ++j) s = fmaf(a[j], b[j], s);
  return s;
}

// acc += c * r
template <int S>
__device__ __forceinline__ void axpy(float c, const float (&r)[S], float (&acc)[S]) {
#pragma unroll
  for (int j = 0; j < S; ++j) acc[j] = fmaf(c, r[j], acc[j]);
}

// The q/k/v projection of head h for the thread's row: for part p (0 q, 1 k,
// 2 v), rows p*E + h*S .. + S of the packed (3E, E) weight are staged and
// row t of Q, K or V = round(x[t] @ W^T). Starts with a __syncthreads (the caller's
// writes to XS, and the previous users of Ws and of the head buffers, are
// done); the caller syncs before other threads read Q, K and V.
template <typename T, int S>
__device__ __forceinline__ void project_head(const float* XS, int ldx, int E, int h, int t,
                                             bool row, const float* __restrict__ wqkv,
                                             float* Ws, float* Q, float* K, float* V) {
#pragma unroll 1
  for (int p = 0; p < 3; ++p) {
    float* dst = p == 0 ? Q : p == 1 ? K : V;
    __syncthreads();
    stage<T, false>(wqkv, E, p * E + h * S, 0, E, S, Ws);
    __syncthreads();
    if (row) {
      float acc[S];
      row_dot<S>(XS + t * ldx, E, Ws, acc);
#pragma unroll
      for (int j = 0; j < S; ++j) dst[t * S + j] = round_to<T>(acc[j]);
    }
  }
}

}  // namespace qkv
