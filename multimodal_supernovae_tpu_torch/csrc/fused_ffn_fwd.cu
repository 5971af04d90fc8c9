// Fused row-local tail of a post-norm transformer block, forward, for Hopper
// (sm_90a), CUDA cores only.
//
// Replaces the Pallas TPU kernel multimodal_supernovae_tpu/ops/fused_block.py
// (_ffn_fwd_kernel, reached through fused_ffn_block / _ffn_fwd_impl) and
// computes exactly ops/fused_block.py:fused_ffn_block_plain of this package,
// over (N, E) rows with compute dtype T (float or bfloat16):
//   a  = round(round(att @ Wu^T) + bu);  r1 = round(a + x)
//   y1 = round(LN1(r1))
//   h  = max(round(round(y1 @ Wf1^T) + bf1), 0)
//   f  = round(round(h @ Wf2^T) + bf2);  r2 = round(f + y1)
//   out = round(LN2(r2))
// where round() rounds to T, every product takes T operands (the float32
// weights are rounded to T as they are staged) and accumulates in float32, and
// LayerNorm takes float32 statistics in the E[x^2] - E[x]^2 form, no clamp.
//
// Design. One block of 256 threads per tile of 32 rows. The att tile, y1 and
// the hidden h stay in shared memory as float32 for the whole tile, so the
// only device-memory traffic is att and x read once and out written once (the
// weights come from L2 in 32-deep chunks staged in shared memory). In each
// product a warp owns 4 rows and a lane 1-8 output columns, float32
// accumulators in registers; A is read as float4 broadcasts, the staged weight
// conflict-free. LayerNorms are one warp per row with shuffle reductions. The
// last tile's rows past N are zero and are not stored.
//
// Stacked members (torch.func.vmap over an ensemble, ops/fused_block.py) are
// grid.y: member m reads its own N rows of att and x, writes its own rows of
// out and reads its own ten parameters, each stacked (M, ...) contiguous; a
// member's tiles are computed as a call for that member alone computes them.
//
// What bounds it on this card: at the light-curve shape (N = 51,200, E = 64,
// F = 256) a launch does 2*N*(E^2 + 2EF) = 3.8 GFLOP against 39 MB (float32)
// of device traffic, so in float32 it is bound by the CUDA cores (67 TFLOP/s:
// 0.056 ms) and not by memory (3.35 TB/s: 0.012 ms). In bfloat16 the work
// would fit the tensor cores, which this first version does not use: the
// products are tiny (K = 64 or 256) per tile, and wgmma/TMA tiles are later
// work. Shared memory: 4 * (32 * (2E + F) + 32 * 257) bytes (82 KB at E = 64,
// F = 256), set with cudaFuncSetAttribute above 48 KB.
//
// Plain C interface, loaded with ctypes (kernels/build.py): the entry returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape or
// dtype it does not take. It launches on the given stream, does not
// synchronise and allocates nothing.

#include "fused_ffn_common.cuh"

namespace {

using namespace ffn;

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) fused_ffn_fwd_kernel(
    const T* __restrict__ att, const T* __restrict__ x, const float* __restrict__ wu,
    const float* __restrict__ bu, const float* __restrict__ g1, const float* __restrict__ b1,
    const float* __restrict__ wf1, const float* __restrict__ bf1,
    const float* __restrict__ wf2, const float* __restrict__ bf2,
    const float* __restrict__ g2, const float* __restrict__ b2, T* __restrict__ out, int N,
    int E, int F, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* A = smem;            // ROWS x E: att, later r2
  float* Y1 = A + ROWS * E;   // ROWS x E: r1, then y1
  float* Hb = Y1 + ROWS * E;  // ROWS x F: h
  float* Ws = Hb + ROWS * F;  // KC x WS_LD: one staged weight chunk
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row0 = (int64_t)blockIdx.x * ROWS;
  const int64_t m = blockIdx.y;  // the member
  att += m * N * E;
  x += m * N * E;
  out += m * N * E;
  wu += m * E * E;
  wf1 += m * F * E;
  wf2 += m * E * F;
  bu += m * E;
  g1 += m * E;
  b1 += m * E;
  bf1 += m * F;
  bf2 += m * E;
  g2 += m * E;
  b2 += m * E;

  for (int idx = threadIdx.x; idx < ROWS * E; idx += THREADS) {
    const int64_t row = row0 + idx / E;
    A[idx] = row < N ? to_float(att[row0 * E + idx]) : 0.f;
  }
  gemm<T, true>(A, E, E, wu, E, Ws, [&](int r, int o, float acc) {
    const int64_t row = row0 + r;
    const float xv = row < N ? to_float(x[row * E + o]) : 0.f;
    const float a = round_to<T>(round_to<T>(acc) + round_to<T>(bu[o]));
    Y1[r * E + o] = round_to<T>(a + xv);
  });
  __syncthreads();
#pragma unroll 1
  for (int i = 0; i < RPW; ++i) {  // LN1, in place
    float* row = Y1 + (warp * RPW + i) * E;
    float v[MAX_EJ];
    const float2 st = ln_stats(row, E, eps, v);
#pragma unroll
    for (int j = 0; j < MAX_EJ; ++j) {
      if (32 * j < E) {
        const int c = lane + 32 * j;
        row[c] = round_to<T>((v[j] - st.x) * st.y * g1[c] + b1[c]);
      }
    }
  }
  gemm<T, true>(Y1, E, E, wf1, F, Ws, [&](int r, int o, float acc) {
    Hb[r * F + o] = fmaxf(round_to<T>(round_to<T>(acc) + round_to<T>(bf1[o])), 0.f);
  });
  gemm<T, true>(Hb, F, F, wf2, E, Ws, [&](int r, int o, float acc) {
    const float f = round_to<T>(round_to<T>(acc) + round_to<T>(bf2[o]));
    A[r * E + o] = round_to<T>(f + Y1[r * E + o]);
  });
  __syncthreads();
#pragma unroll 1
  for (int i = 0; i < RPW; ++i) {  // LN2, stored
    const int r = warp * RPW + i;
    const int64_t row = row0 + r;
    float v[MAX_EJ];
    const float2 st = ln_stats(A + r * E, E, eps, v);
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < MAX_EJ; ++j) {
      if (32 * j < E) {
        const int c = lane + 32 * j;
        out[row * E + c] = from_float<T>((v[j] - st.x) * st.y * g2[c] + b2[c]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* att, const void* x, const float* const* p, void* out, int M,
                   int N, int E, int F, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)ROWS * (2 * E + F) + KC * WS_LD);
  cudaError_t err = cudaFuncSetAttribute(fused_ffn_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (N + ROWS - 1) / ROWS;
  fused_ffn_fwd_kernel<T><<<dim3(tiles, M), THREADS, smem, stream>>>(
      static_cast<const T*>(att), static_cast<const T*>(x), p[0], p[1], p[2], p[3], p[4],
      p[5], p[6], p[7], p[8], p[9], static_cast<T*>(out), N, E, F, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (att, x and out); the ten parameters are
// float32, contiguous: wu (E, E), bu (E), g1 (E), b1 (E), wf1 (F, E), bf1 (F),
// wf2 (E, F), bf2 (E), g2 (E), b2 (E), weights as a Linear's (out, in).
// att, x and out are contiguous (N, E). M >= 1 stacked members: att, x and out
// (M, N, E), every parameter (M, ...) contiguous, one launch for all of them.
extern "C" int mmsn_fused_ffn_fwd(const void* att, const void* x, const void* wu,
                                  const void* bu, const void* g1, const void* b1,
                                  const void* wf1, const void* bf1, const void* wf2,
                                  const void* bf2, const void* g2, const void* b2,
                                  void* out, int M, int N, int E, int F, int dtype, float eps,
                                  void* stream) {
  // M is grid.y: at most 65535
  if (M < 1 || M > 65535 || N < 1 || E < 32 || F < 32 || E % 32 || F % 32 ||
      E > 32 * MAX_EJ) {
    return cudaErrorInvalidValue;
  }
  const float* p[10] = {
      static_cast<const float*>(wu), static_cast<const float*>(bu),
      static_cast<const float*>(g1), static_cast<const float*>(b1),
      static_cast<const float*>(wf1), static_cast<const float*>(bf1),
      static_cast<const float*>(wf2), static_cast<const float*>(bf2),
      static_cast<const float*>(g2), static_cast<const float*>(b2)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(att, x, p, out, M, N, E, F, eps, st);
    case 1: return launch<__nv_bfloat16>(att, x, p, out, M, N, E, F, eps, st);
    default: return cudaErrorInvalidValue;
  }
}
