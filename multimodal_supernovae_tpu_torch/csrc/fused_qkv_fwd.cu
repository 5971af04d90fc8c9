// The whole SelfAttention forward as one kernel, for Hopper (sm_90a), CUDA
// cores only: packed q/k/v projection, head split, masked attention and the
// biased head unification over one sample per block.
//
// Replaces the Pallas TPU kernel multimodal_supernovae_tpu/ops/
// qkv_attention.py (_fwd_kernel, reached through _qkv_fwd_impl) and computes
// exactly ops/qkv_attention.py:fused_qkv_attention_plain of this package, with
// the JAX kernel's rounding points (T is the compute dtype, float or bf16):
//   qkv = round(x @ Wqkv^T), weights rounded to T, float32 accumulation;
//   s = q . k in float32, masked keys SET to -1e7; row max m, e = exp(s - m)
//   and row sum l in float32; att = round((sum_u round(e) * v) / l);
//   out = round(round(att @ Wu^T) + round(bu)).
// x is (B, T, E) and out the same; the packed weight is (3E, E) in a Linear's
// (out, in) layout with the emb**-0.25 scaling already folded into its q and k
// rows; keys past T do not exist (no padding), so a fully masked sample
// averages v over its T keys.
//
// The TPU kernel holds NB samples' (3E, Tp) projections and (H, Tp, Tp) scores
// in VMEM. Here a block holds one sample: x and the merged head outputs as
// (T, E + 1) float32 rows and, for one head at a time, q, k and v as (T, S)
// rows. Thread t owns sequence position t: it projects its row against weight
// slices staged in shared memory, then walks all T keys twice (the row max,
// then exp, sum and the value product; k and v rows are float4 broadcasts),
// and at the end multiplies its att row with Wu in passes of 32 columns. The
// scores never leave registers and q, k, v never leave the SM.
//
// What bounds it on this card: CUDA-core work, not bytes. At the light-curve
// shape (B, T, E, H) = (256, 200, 64, 8) a launch reads and writes 13 MB
// (0.004 ms at 3.35 TB/s) and does 0.5 GFLOP of projections plus 3 * T * T * S
// multiply-adds a head; with one 256-thread block and 132 KB of shared memory
// a sample, one block runs on an SM and it is latency-bound at 8 warps. Tensor cores are out: the head dim of 8 is
// below every MMA tile.
//
// Stacked members (torch.func.vmap over an ensemble, ops/qkv_attention.py)
// are grid.y: block (b, m) computes sample b of member m, whose x, mask and out
// rows follow member m - 1's ((M, B, ...) stacked) and whose Wqkv, Wu and bu
// are its own ((M, ...) stacked), as a call for member m alone computes it.
//
// Shared memory: 4 * (32 E + 3 T S + 2 T (E + 1) + T) bytes.
//
// Plain C interface, loaded with ctypes (kernels/build.py): the entry returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape or
// dtype it does not take. It launches on the given stream, does not
// synchronise and allocates nothing.

#include "fused_qkv_common.cuh"

namespace {

using namespace qkv;

template <typename T, int S>
__global__ void __launch_bounds__(THREADS) fused_qkv_fwd_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ mask,
    const float* __restrict__ wqkv, const float* __restrict__ wu,
    const float* __restrict__ bu, T* __restrict__ out, int Tn, int E) {
  extern __shared__ __align__(16) float smem[];
  const int H = E / S;
  const int ldx = E + 1;
  float* Ws = smem;             // E x EC staged weight slice
  float* Q = Ws + E * EC;       // Tn x S, one head
  float* K = Q + Tn * S;
  float* V = K + Tn * S;
  float* XS = V + Tn * S;       // Tn x ldx: x
  float* ATT = XS + Tn * ldx;   // Tn x ldx: merged head outputs
  float* VAL = ATT + Tn * ldx;  // Tn: 1 where the key is valid

  const int64_t m = blockIdx.y;  // the member
  const int64_t b = m * gridDim.x + blockIdx.x;  // its sample, in the stacked rows
  wqkv += m * 3 * E * E;
  wu += m * E * E;
  bu += m * E;
  const int t = threadIdx.x;
  const bool row = t < Tn;
  const T* xb = x + b * Tn * E;
  for (int idx = t; idx < Tn * E; idx += THREADS)
    XS[(idx / E) * ldx + idx % E] = to_float(xb[idx]);
  if (row) VAL[t] = (mask == nullptr || mask[b * Tn + t]) ? 1.f : 0.f;

#pragma unroll 1
  for (int h = 0; h < H; ++h) {
    project_head<T, S>(XS, ldx, E, h, t, row, wqkv, Ws, Q, K, V);
    __syncthreads();
    if (row) {
      float q[S], r[S];
      load_row<S>(Q + t * S, q);
      float m = -INFINITY;
      for (int u = 0; u < Tn; ++u) {
        load_row<S>(K + u * S, r);
        const float s = VAL[u] != 0.f ? dot<S>(q, r) : MASK_FILL;
        m = fmaxf(m, s);
      }
      float l = 0.f;
      float acc[S];
#pragma unroll
      for (int j = 0; j < S; ++j) acc[j] = 0.f;
      for (int u = 0; u < Tn; ++u) {
        load_row<S>(K + u * S, r);
        const float s = VAL[u] != 0.f ? dot<S>(q, r) : MASK_FILL;
        const float e = __expf(s - m);
        l += e;
        load_row<S>(V + u * S, r);
        axpy<S>(round_to<T>(e), r, acc);
      }
#pragma unroll
      for (int j = 0; j < S; ++j) ATT[t * ldx + h * S + j] = round_to<T>(acc[j] / l);
    }
  }

  // head unification: out = round(att @ Wu^T) + bu, EC columns a pass
  T* ob = out + (b * Tn + t) * E;
#pragma unroll 1
  for (int o0 = 0; o0 < E; o0 += EC) {
    __syncthreads();
    stage<T, false>(wu, E, o0, 0, E, EC, Ws);
    __syncthreads();
    if (row) {
      float acc[EC];
      row_dot<EC>(ATT + t * ldx, E, Ws, acc);
#pragma unroll
      for (int j = 0; j < EC; ++j)
        ob[o0 + j] = from_float<T>(round_to<T>(acc[j]) + round_to<T>(bu[o0 + j]));
    }
  }
}

template <typename T, int S>
cudaError_t launch(const void* x, const void* mask, const float* wqkv, const float* wu,
                   const float* bu, void* out, int M, int B, int Tn, int E,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)E * EC + 3 * (size_t)Tn * S + 2 * (size_t)Tn * (E + 1) + Tn);
  cudaError_t err = cudaFuncSetAttribute(fused_qkv_fwd_kernel<T, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  fused_qkv_fwd_kernel<T, S><<<dim3(B, M), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(mask), wqkv, wu, bu,
      static_cast<T*>(out), Tn, E);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_s(int S, const void* x, const void* mask, const float* wqkv,
                     const float* wu, const float* bu, void* out, int M, int B, int Tn, int E,
                     cudaStream_t stream) {
  switch (S) {
    case 8: return launch<T, 8>(x, mask, wqkv, wu, bu, out, M, B, Tn, E, stream);
    case 16: return launch<T, 16>(x, mask, wqkv, wu, bu, out, M, B, Tn, E, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, out: contiguous (B, T, E)). mask: bool
// (B, T), one byte each, or null for all keys valid. wqkv float32 (3E, E), wu
// float32 (E, E), bu float32 (E). 1 <= T <= 256, E a multiple of 32, E / H in
// {8, 16}. M >= 1 stacked members: x and out (M, B, T, E), mask (M, B, T) or
// null, wqkv (M, 3E, E), wu (M, E, E), bu (M, E), one launch for all of them.
extern "C" int mmsn_fused_qkv_fwd(const void* x, const void* mask, const void* wqkv,
                                  const void* wu, const void* bu, void* out, int M, int B,
                                  int T, int E, int H, int dtype, void* stream) {
  // M is grid.y: at most 65535
  if (M < 1 || M > 65535 || B < 1 || T < 1 || T > THREADS || E < EC || E % EC || H < 1 ||
      E % H) {
    return cudaErrorInvalidValue;
  }
  const float* w = static_cast<const float*>(wqkv);
  const float* u = static_cast<const float*>(wu);
  const float* bias = static_cast<const float*>(bu);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_s<float>(E / H, x, mask, w, u, bias, out, M, B, T, E, st);
    case 1: return launch_s<__nv_bfloat16>(E / H, x, mask, w, u, bias, out, M, B, T, E, st);
    default: return cudaErrorInvalidValue;
  }
}
