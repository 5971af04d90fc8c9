// Masked multi-head attention forward for Hopper (sm_90a), CUDA cores only.
//
// Replaces the Pallas TPU kernel multimodal_supernovae_tpu/ops/pallas_attention.py
// (_fwd_kernel, reached through flash_attention / _flash_fwd_impl) and computes
// exactly ops/attention.py:dense_attention of this package:
//   * q and k scaled by emb**-0.25 (emb = H * S, the FULL embedding dim), each
//     product rounded to the input dtype as the plain version rounds it;
//   * float32 scores; a key j < T with mask[b, j] false gets the score -1e7
//     (so a fully masked row gets uniform weights over its T keys); keys past
//     T in the last tile are excluded outright;
//   * softmax probabilities rounded to v's dtype before the P.V product,
//     float32 accumulation, output divided by the row sum, stored in the input
//     dtype.
//
// Design. grid = (B*H, ceil(T/BQ)); one thread owns one query row and keeps
// its scaled q, an online-softmax state (running max, running sum) and the
// S-wide accumulator in float32 registers. K/V are walked in tiles of BK keys
// staged by the whole block in shared memory as float32; every thread of a
// warp then reads the same key row, a broadcast with no bank conflicts. The
// whole (T, T) score row of the TPU kernel is never held: at T = 1024 it would
// not fit a block's shared memory, so the key loop is tiled and the softmax is
// online. Scores are kept in the log2 domain (q carries a factor log2(e)) so
// every exponential is one exp2f.
//
// Head dims. The kernel is instantiated at a capacity S in {4, 8, 16, 32, 64}
// and takes the true head dim s <= S at run time: loads past s read 0 and
// stores past s are skipped. The zero columns add nothing to any q . k or
// P . V, so every head dim from 1 to 64 gives the dense results, and q, k, v
// and out are read and written in place at their own strides (no padded
// copy).
//
// What bounds it on this card: compute on the CUDA cores. Per query row and
// key it does 2*S FMAs and one exponential and reads only shared memory; at
// the serving shapes the device-memory traffic is q/k/v/out once per q-tile.
// The LC head_dim (8) is below every MMA tile, so no tensor cores here; a
// wgmma/TMA version for S >= 16 is later work.
//
// Training residual: given a non-null ``stats``, each row also stores its final
// (max, sum) in float32 as (B*H*T, 2), the log-sum-exp in two parts, for the
// backward kernel (csrc/flash_attention_bwd.cu) to rebuild P without a second
// softmax pass. Kept as two numbers, not m + log2(l): a fully masked row has
// m = -1e7*log2(e), where a float32 has no room left for log2(l). Serving
// launches pass null and store nothing more.
//
// Plain C interface, loaded with ctypes (kernels/build.py): the entry returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape or
// dtype it does not take. It launches on the given stream, does not
// synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int BQ = 128;  // query rows per block, one per thread
constexpr int BK = 32;   // keys per shared-memory tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK_FILL_LOG2 = -1e7f * LOG2E;

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

// Round through the storage dtype (the identity for float).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

template <typename T, int S>
__global__ void __launch_bounds__(BQ) flash_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, T* __restrict__ out,
    float2* __restrict__ stats, int H, int T_len, int s_dim, float scale, int64_t sib,
    int64_t sih, int64_t sit, int64_t sob, int64_t soh, int64_t sot) {
  static_assert(S % 4 == 0, "head dim must be a multiple of 4");
  __shared__ __align__(16) float ks[BK][S];
  __shared__ __align__(16) float vs[BK][S];
  __shared__ uint8_t kind[BK];  // 0 valid key, 1 masked key, 2 past T

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row = blockIdx.y * BQ + threadIdx.x;
  const bool active = row < T_len;
  const int64_t base = b * sib + h * sih;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

  float qr[S];
#pragma unroll
  for (int d = 0; d < S; ++d) {
    qr[d] = active && d < s_dim ? round_to<T>(to_float(qb[row * sit + d]) * scale) * LOG2E : 0.f;
  }
  float acc[S];
#pragma unroll
  for (int d = 0; d < S; ++d) acc[d] = 0.f;
  float m = -INFINITY;  // running max (log2 domain)
  float l = 0.f;        // running sum of the unrounded probabilities

  for (int j0 = 0; j0 < T_len; j0 += BK) {
    __syncthreads();  // the previous tile has been consumed
    for (int idx = threadIdx.x; idx < BK * S; idx += BQ) {
      const int j = idx / S;
      const int d = idx - j * S;
      const int key = j0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < T_len && d < s_dim) {
        kv = round_to<T>(to_float(kb[key * sit + d]) * scale);
        vv = to_float(vb[key * sit + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    if (threadIdx.x < BK) {
      const int key = j0 + threadIdx.x;
      kind[threadIdx.x] = key >= T_len ? 2 : (mask != nullptr && !mask[(int64_t)b * T_len + key]) ? 1 : 0;
    }
    __syncthreads();

    float s[BK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < S; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d]);
        dot = fmaf(qr[d], kk.x, dot);
        dot = fmaf(qr[d + 1], kk.y, dot);
        dot = fmaf(qr[d + 2], kk.z, dot);
        dot = fmaf(qr[d + 3], kk.w, dot);
      }
      const uint8_t kd = kind[j];
      s[j] = kd == 0 ? dot : (kd == 1 ? MASK_FILL_LOG2 : -INFINITY);
      tile_max = fmaxf(tile_max, s[j]);
    }
    // Key j0 < T is in every tile, so m_new is finite. exp2f(-inf) = 0 drops
    // the old state when m was -inf, and an all-masked earlier tile
    // (m = -1e7 * log2e) is wiped by the first valid key: exp2 underflows to 0.
    const float m_new = fmaxf(m, tile_max);
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < S; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = exp2f(s[j] - m_new);
      l += p;
      const float pr = round_to<T>(p);
#pragma unroll
      for (int d = 0; d < S; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][d]);
        acc[d] = fmaf(pr, vv.x, acc[d]);
        acc[d + 1] = fmaf(pr, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(pr, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(pr, vv.w, acc[d + 3]);
      }
    }
    m = m_new;
  }

  if (active) {
    T* o = out + b * sob + h * soh + row * sot;
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < S; ++d) {
      if (d < s_dim) o[d] = from_float<T>(acc[d] * inv);
    }
    if (stats != nullptr) stats[(int64_t)bh * T_len + row] = make_float2(m, l);
  }
}

template <typename T, int S>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* out, float2* stats, int B, int H, int T_len,
                   int s_dim, float scale, int64_t sib, int64_t sih, int64_t sit,
                   int64_t sob, int64_t soh, int64_t sot, cudaStream_t stream) {
  const dim3 grid(B * H, (T_len + BQ - 1) / BQ);
  flash_attention_fwd_kernel<T, S><<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), stats, H, T_len, s_dim, scale,
      sib, sih, sit, sob, soh, sot);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(int S, const void* q, const void* k,
                              const void* v, const uint8_t* mask, void* out,
                              float2* stats,
                              int B, int H, int T_len, float scale,
                              int64_t sib, int64_t sih, int64_t sit,
                              int64_t sob, int64_t soh, int64_t sot,
                              cudaStream_t stream) {
  // the smallest capacity that holds the head dim
  if (S < 1) return cudaErrorInvalidValue;
  if (S <= 4)
    return launch<T, 4>(q, k, v, mask, out, stats, B, H, T_len, S, scale, sib, sih, sit, sob, soh, sot, stream);
  if (S <= 8)
    return launch<T, 8>(q, k, v, mask, out, stats, B, H, T_len, S, scale, sib, sih, sit, sob, soh, sot, stream);
  if (S <= 16)
    return launch<T, 16>(q, k, v, mask, out, stats, B, H, T_len, S, scale, sib, sih, sit, sob, soh, sot, stream);
  if (S <= 32)
    return launch<T, 32>(q, k, v, mask, out, stats, B, H, T_len, S, scale, sib, sih, sit, sob, soh, sot, stream);
  if (S <= 64)
    return launch<T, 64>(q, k, v, mask, out, stats, B, H, T_len, S, scale, sib, sih, sit, sob, soh, sot, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; S is the head dim, 1 to 64. q, k, v share
// the strides (sib, sih, sit) of their (B, H, T) dims and out has (sob, soh,
// sot); the S dim is contiguous
// in all four. mask is (B, T) bytes, contiguous, or null for "all valid".
// stats is null or (B*H*T, 2) float32, contiguous: the rows' (max, sum).
extern "C" int mmsn_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* out,
    void* stats, int B, int H, int T_len, int S, int dtype, float scale, int64_t sib,
    int64_t sih, int64_t sit, int64_t sob, int64_t soh, int64_t sot,
    void* stream) {
  if (B < 1 || H < 1 || T_len < 1 || (int64_t)B * H > 0x7fffffff) return cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float2* rs = static_cast<float2*>(stats);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_head_dim<float>(S, q, k, v, m, out, rs, B, H, T_len, scale, sib, sih, sit, sob, soh, sot, st);
    case 1:
      return dispatch_head_dim<__nv_bfloat16>(S, q, k, v, m, out, rs, B, H, T_len, scale, sib, sih, sit, sob, soh, sot, st);
    default:
      return cudaErrorInvalidValue;
  }
}
