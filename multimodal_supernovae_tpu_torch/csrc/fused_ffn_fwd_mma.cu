// Fused row-local tail of a post-norm transformer block, forward, float32, on
// Hopper's tensor cores (sm_90a, mma.sync in 3xTF32).
//
// Replaces the Pallas TPU kernel multimodal_supernovae_tpu/ops/fused_block.py
// (_ffn_fwd_kernel, reached through fused_ffn_block / _ffn_fwd_impl) on the
// float32 path, and computes ops/fused_block.py:fused_ffn_block_plain of this
// package over float32 (N, E) rows, as csrc/fused_ffn_fwd.cu (the CUDA-core
// kernel, which also takes bfloat16) does:
//   r1 = (att @ Wu^T + bu) + x;          y1 = LN1(r1)
//   h  = max(y1 @ Wf1^T + bf1, 0)
//   r2 = (h @ Wf2^T + bf2) + y1;         out = LN2(r2)
// LayerNorm takes float32 statistics in the E[x^2] - E[x]^2 form, eps given,
// no clamp. Every product is 3xTF32 with float32 accumulation
// (csrc/tf32x3.cuh): about float32 accuracy on the tensor cores.
//
// What bounds it on this card: at the light-curve shape (N = 51,200, E = 64,
// F = 256) a launch does 2 N (E^2 + 2 E F) = 3.775 GFLOP, three TF32 passes of
// it at 495 TFLOP/s: 0.0229 ms, against 4 (3 N E + E^2 + 2 E F + 6 E + F)
// bytes = 39.5 MB at 3.35 TB/s: 0.0118 ms. Operations bound it.
//
// Design. A block of 4 warps owns 64 rows, warp w rows 16w .. 16w + 15 (one
// m16 tile) in every product and row pass, so the warps meet only where the
// block stages weights. The att tile goes to shared memory once; Wu, then
// each 64-column chunk c of the hidden width (Wf1 rows c, Wf2 columns c), is
// split into TF32 hi and lo as it is staged, once per block. Per warp:
//   a = att . Wu^T in registers (C fragments); bias, residual and LN1 on the
//     fragments (a row's E values lie on the 4 lanes of a quad: two
//     shuffles), y1 written over the warp's att rows;
//   per chunk: h_c = relu(y1 . Wf1[c]^T + bf1[c]) into the warp's shared h
//     rows, then f += h_c . Wf2[:, c]^T, f (16 x E) kept in registers;
//   bias, y1 residual and LN2 on f's fragments, stored from them.
// A product's C fragments do not map onto the next one's A fragments in TF32
// m16n8k8, so y1 and h go through the warp's own shared rows (__syncwarp, no
// block barrier). B fragments are read pre-split (4 shared loads a 3xTF32
// step), A fragments split as loaded (reused over a row of n tiles). Rows
// past N are zero on load and never stored.
//
// Shared memory, floats: 64 (E + 4) [att, then y1] + 64 (64 + 4) [h chunk] +
// max(2 E (E + 4) [Wu hi, lo], 2 * 64 (E + 4) + 2 E (64 + 4) [Wf1, Wf2 chunk
// hi, lo]); 104,448 bytes at E = 64 (two blocks an SM), 188,416 at E = 128.
//
// ptxas on the card (sm_90a, -O3): 118 registers at E = 64, 159 at
// E = 96, 178 at E = 128; no spills.
//
// Plain C interface, loaded with ctypes (kernels/build.py): the entry returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape or
// alignment it does not take. It launches on the given stream, does not
// synchronise and allocates nothing.

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;  // rows a block owns
constexpr int FC = 64;            // hidden columns a chunk

template <int E>
struct Layout {
  static constexpr int XLD = E + PAD;   // att / y1 rows
  static constexpr int HLD = FC + PAD;  // h rows
  static constexpr int WU = E * XLD;    // Wu (E x E), each of hi and lo
  static constexpr int W1 = FC * XLD;   // a chunk of Wf1 (FC x E)
  static constexpr int W2 = E * HLD;    // a chunk of Wf2 (E x FC)
  static constexpr int WS = 2 * WU > 2 * (W1 + W2) ? 2 * WU : 2 * (W1 + W2);
  static constexpr int FLOATS = ROWS * XLD + ROWS * HLD + WS;
};

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// Bias and residual into the C fragments v of the warp's rows (g, g + 8);
// then LayerNorm over each row's E values: v becomes xhat * gamma + beta.
// res(half, c) gives the residual pair at column c of row g (half 0) or
// g + 8 (half 1).
template <int NT, typename Res>
__device__ __forceinline__ void bias_residual_ln(float (&v)[NT][4], const float* __restrict__ bias,
                                                 const float* __restrict__ gamma,
                                                 const float* __restrict__ beta, float eps,
                                                 int t, Res res) {
  float s[2] = {0.f, 0.f}, ss[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 b = ldg2(bias + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 r = res(h, c);
      v[j][2 * h] = (v[j][2 * h] + b.x) + r.x;
      v[j][2 * h + 1] = (v[j][2 * h + 1] + b.y) + r.y;
      s[h] += v[j][2 * h] + v[j][2 * h + 1];
      ss[h] += v[j][2 * h] * v[j][2 * h] + v[j][2 * h + 1] * v[j][2 * h + 1];
    }
  }
  float mean[2], rstd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mean[h] = quad_sum(s[h]) / (8 * NT);
    rstd[h] = rsqrtf(quad_sum(ss[h]) / (8 * NT) - mean[h] * mean[h] + eps);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 gm = ldg2(gamma + c), bt = ldg2(beta + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[j][2 * h] = (v[j][2 * h] - mean[h]) * rstd[h] * gm.x + bt.x;
      v[j][2 * h + 1] = (v[j][2 * h + 1] - mean[h]) * rstd[h] * gm.y + bt.y;
    }
  }
}

template <int E>
__global__ void __launch_bounds__(THREADS, 2) fused_ffn_fwd_mma_kernel(
    const float* __restrict__ att, const float* __restrict__ x, const float* __restrict__ wu,
    const float* __restrict__ bu, const float* __restrict__ g1, const float* __restrict__ b1,
    const float* __restrict__ wf1, const float* __restrict__ bf1,
    const float* __restrict__ wf2, const float* __restrict__ bf2,
    const float* __restrict__ g2, const float* __restrict__ b2, float* __restrict__ out,
    int N, int F, float eps) {
  using L = Layout<E>;
  constexpr int NT = E / 8;   // n tiles of an E-wide output
  constexpr int HT = FC / 8;  // n tiles of a hidden chunk
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;                 // ROWS x XLD: att, then y1
  float* Hs = Xs + ROWS * L::XLD;   // ROWS x HLD: h of one chunk
  uint32_t* Ws = reinterpret_cast<uint32_t*>(Hs + ROWS * L::HLD);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t row0 = (int64_t)blockIdx.x * ROWS;
  float* Xw = Xs + warp * 16 * L::XLD;  // the warp's 16 rows
  float* Hw = Hs + warp * 16 * L::HLD;
  const int64_t ra = row0 + warp * 16 + g;  // the lane's rows: ra and ra + 8

  for (int idx = threadIdx.x; idx < ROWS * (E / 4); idx += THREADS) {
    const int r = idx / (E / 4);
    const int c = (idx - r * (E / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < N) v = __ldg(reinterpret_cast<const float4*>(att + (row0 + r) * E + c));
    *reinterpret_cast<float4*>(Xs + r * L::XLD + c) = v;
  }
  stage_split<THREADS>(Ws, Ws + L::WU, L::XLD, wu, E, E, E);
  __syncthreads();

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  warp_product<NT, E>(acc, Xw, L::XLD, Ws, Ws + L::WU, L::XLD, lane);
  bias_residual_ln(acc, bu, g1, b1, eps, t, [&](int h, int c) {
    const int64_t row = ra + 8 * h;
    return row < N ? ldg2(x + row * E + c) : make_float2(0.f, 0.f);
  });
  __syncwarp();  // every lane has read its att fragments
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = 8 * j + 2 * t;
    *reinterpret_cast<float2*>(Xw + g * L::XLD + c) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(Xw + (g + 8) * L::XLD + c) = make_float2(acc[j][2], acc[j][3]);
  }
  __syncwarp();

  float f[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) f[j][0] = f[j][1] = f[j][2] = f[j][3] = 0.f;
  uint32_t* W1hi = Ws;
  uint32_t* W1lo = Ws + L::W1;
  uint32_t* W2hi = Ws + 2 * L::W1;
  uint32_t* W2lo = W2hi + L::W2;
#pragma unroll 1
  for (int c0 = 0; c0 < F; c0 += FC) {
    __syncthreads();  // every warp is done with the staged weights before
    stage_split<THREADS>(W1hi, W1lo, L::XLD, wf1 + (int64_t)c0 * E, E, FC, E);
    stage_split<THREADS>(W2hi, W2lo, L::HLD, wf2 + c0, F, E, FC);
    __syncthreads();
    float hacc[HT][4];
#pragma unroll
    for (int j = 0; j < HT; ++j) hacc[j][0] = hacc[j][1] = hacc[j][2] = hacc[j][3] = 0.f;
    warp_product<HT, E>(hacc, Xw, L::XLD, W1hi, W1lo, L::XLD, lane);
#pragma unroll
    for (int j = 0; j < HT; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 b = ldg2(bf1 + c0 + c);
      *reinterpret_cast<float2*>(Hw + g * L::HLD + c) =
          make_float2(fmaxf(hacc[j][0] + b.x, 0.f), fmaxf(hacc[j][1] + b.y, 0.f));
      *reinterpret_cast<float2*>(Hw + (g + 8) * L::HLD + c) =
          make_float2(fmaxf(hacc[j][2] + b.x, 0.f), fmaxf(hacc[j][3] + b.y, 0.f));
    }
    __syncwarp();
    warp_product<NT, FC>(f, Hw, L::HLD, W2hi, W2lo, L::HLD, lane);
  }

  bias_residual_ln(f, bf2, g2, b2, eps, t, [&](int h, int c) {
    return *reinterpret_cast<const float2*>(Xw + (g + 8 * h) * L::XLD + c);
  });
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t row = ra + 8 * h;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<float2*>(out + row * E + 8 * j + 2 * t) =
          make_float2(f[j][2 * h], f[j][2 * h + 1]);
    }
  }
}

template <int E>
cudaError_t launch(const float* att, const float* x, const float* const* p, float* out, int N,
                   int F, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * Layout<E>::FLOATS;
  cudaError_t err = cudaFuncSetAttribute(fused_ffn_fwd_mma_kernel<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (N + ROWS - 1) / ROWS;
  fused_ffn_fwd_mma_kernel<E><<<tiles, THREADS, smem, stream>>>(
      att, x, p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], out, N, F, eps);
  return cudaGetLastError();
}

}  // namespace

// float32 throughout, every pointer on 16 bytes: att, x and out contiguous
// (N, E); the ten parameters contiguous: wu (E, E), bu (E), g1 (E), b1 (E),
// wf1 (F, E), bf1 (F), wf2 (E, F), bf2 (E), g2 (E), b2 (E), weights as a
// Linear's (out, in). E is 64, 96 or 128; F a multiple of 64.
extern "C" int mmsn_fused_ffn_fwd_mma(const void* att, const void* x, const void* wu,
                                      const void* bu, const void* g1, const void* b1,
                                      const void* wf1, const void* bf1, const void* wf2,
                                      const void* bf2, const void* g2, const void* b2,
                                      void* out, int N, int E, int F, float eps,
                                      void* stream) {
  const void* ptrs[13] = {att, x, wu, bu, g1, b1, wf1, bf1, wf2, bf2, g2, b2, out};
  for (const void* q : ptrs) {
    if (reinterpret_cast<uintptr_t>(q) % 16) return cudaErrorInvalidValue;
  }
  if (N < 1 || F < FC || F % FC) return cudaErrorInvalidValue;
  const float* p[10] = {
      static_cast<const float*>(wu), static_cast<const float*>(bu),
      static_cast<const float*>(g1), static_cast<const float*>(b1),
      static_cast<const float*>(wf1), static_cast<const float*>(bf1),
      static_cast<const float*>(wf2), static_cast<const float*>(bf2),
      static_cast<const float*>(g2), static_cast<const float*>(b2)};
  const float* a = static_cast<const float*>(att);
  const float* xx = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (E) {
    case 64: return launch<64>(a, xx, p, o, N, F, eps, st);
    case 96: return launch<96>(a, xx, p, o, N, F, eps, st);
    case 128: return launch<128>(a, xx, p, o, N, F, eps, st);
    default: return cudaErrorInvalidValue;
  }
}
