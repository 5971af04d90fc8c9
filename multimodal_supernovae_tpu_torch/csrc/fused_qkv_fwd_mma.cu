// The whole SelfAttention forward as one kernel on Hopper's tensor cores
// (sm_90a, mma.sync), bf16 at (E, head dim) = (32, 8), (32, 16) and (64, 8):
// packed q/k/v projection, head split, masked attention and the biased head
// unification over one sample a block.
//
// Replaces the Pallas TPU kernel multimodal_supernovae_tpu/ops/
// qkv_attention.py (_fwd_kernel, reached through _qkv_fwd_impl) on the bf16
// path, and computes what csrc/fused_qkv_fwd.cu (the CUDA-core kernel, which
// keeps float32) computes, ops/qkv_attention.py:fused_qkv_attention_plain of
// this package, at the JAX kernel's rounding points:
//   qkv = bf16(x . bf16(Wqkv)^T), float32 accumulation;
//   s = q . k in float32, masked keys SET to -1e7, keys past T left out;
//   e = exp(s - max over all keys); att = bf16((sum_u bf16(e) v) / sum_u e);
//   out = bf16(bf16(att . bf16(Wu)^T) + bf16(bu)).
// Every product is one bf16 mma.sync with float32 accumulation, and those
// rounding points are exactly its operand types: x . Wqkv^T and att . Wu^T
// with m16n8k16, q . k^T with m16n8k8 at head dim 8 (m16n8k16 at 16), and
// bf16(e) . v with m16n8k16, e's C fragments packed into the A fragment in
// registers (flash_mma::c_to_a). q, k, v and att never reach device memory.
//
// The softmax takes two passes over the keys, the row max first and then the
// exponentials against it, as the plain version and the JAX kernel do. T <=
// 256 keeps the whole key set in shared memory, so the second pass costs one
// more q . k^T (a few mma a key tile, the cheap part), and bf16(e) rounds the
// same values as the plain version's: an online running max, as in
// csrc/flash_attention_fwd_mma.cu, would round e against a partial max and
// rescale after. The exponentials are ex2.approx in the log2 domain.
//
// Layout (csrc/fused_qkv_mma.cuh): one block of 16 warps a sample, warp w
// owning rows 16w .. 16w + 15. x (cp.async), the staged weights (float32 ->
// bf16) and each key's mask kind go to shared memory; each warp projects its
// row tile against the staged Wqkv, keeps its q as A fragments in registers
// and writes k and v to shared (Tp, E) buffers; after one barrier each warp
// runs the attention of its rows for every head and keeps att as the A
// fragments of the unify product, whose output it rounds, biases and stores.
//
// What bounds it on this card: at the light-curve shape (B, T, E, H) = (256,
// 200, 64, 8) the products are 2.2 GFLOP (2 us at 989 TFLOP/s) and the bytes
// 13 MB (4 us at 3.35 TB/s); the 82M exponentials alone take 20 us on the
// MUFU pipes. One 16-warp block an SM (148 KB of shared memory at T = 256,
// E = 64), 256 samples in two waves over 132 SMs.
//
// Stacked members (torch.func.vmap over an ensemble, ops/qkv_attention.py)
// are grid.y: block (b, m) computes sample b of member m, whose x, mask and out
// rows follow member m - 1's ((M, B, ...) stacked) and whose Wqkv, Wu and bu
// are its own ((M, ...) stacked), as a call for member m alone computes it.
//
// Shared memory: 2 (E + 8) (3 Tp + 4 E) + Tp bytes, Tp = ceil16(T).
//
// Plain C interface, loaded with ctypes (kernels/build.py): the entry returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape or
// alignment it does not take. It launches on the given stream, does not
// synchronise and allocates nothing.

#include "fused_qkv_mma.cuh"

#include <cmath>

namespace {

using namespace qkv_mma;

struct FwdArgs {  // each with a leading member axis (M, ...) when stacked
  const bf16* x;        // (B, T, E)
  const uint8_t* mask;  // (B, T) bytes or null
  const float* wqkv;    // (3E, E), scaling folded into the q and k rows
  const float* wu;      // (E, E)
  const float* bu;      // (E)
  bf16* out;            // (B, T, E)
  int T_len;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Scores of the warp's 16 query rows against keys 16 kc .. 16 kc + 15 of one
// head (k points at the head's columns), after the mask, in the log2 domain.
template <int S, int RS>
__device__ __forceinline__ void head_scores(float (&s)[2][4], const uint32_t (&q)[S / 4],
                                            const bf16* k, const uint8_t* kind, int kc,
                                            int lane) {
  const int t = lane & 3;
  head_product<S>(s, q, k, RS, kc, lane);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = masked_log2(s[i][e], kind[16 * kc + 8 * i + 2 * t + (e & 1)]);
  }
}

template <int E, int S>
__global__ void __launch_bounds__(THREADS, 1) fused_qkv_fwd_mma_kernel(const FwdArgs a) {
  constexpr int RS = Dims<E>::RS, H = E / S;
  extern __shared__ __align__(16) unsigned char smem[];
  const int T_len = a.T_len, Tp = pad16(T_len);
  bf16* X = reinterpret_cast<bf16*>(smem);  // (Tp, E): x
  bf16* K = X + Tp * RS;                     // (Tp, E): k, all heads
  bf16* V = K + Tp * RS;                     // (Tp, E): v
  bf16* WQ = V + Tp * RS;                    // (3E, E): bf16(Wqkv)
  bf16* WU = WQ + 3 * E * RS;                // (E, E): bf16(Wu)
  uint8_t* kind = reinterpret_cast<uint8_t*>(WU + E * RS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t m = blockIdx.y;                  // the member
  const int64_t b = m * gridDim.x + blockIdx.x;  // its sample, in the stacked rows
  const float* bu = a.bu + m * E;
  load_rows_async<E>(X, a.x + b * T_len * E, T_len, tid);
  cp_async_commit();
  stage_weight<E>(WQ, a.wqkv + m * 3 * E * E, 3 * E, tid);
  stage_weight<E>(WU, a.wu + m * E * E, E, tid);
  write_kinds(kind, a.mask != nullptr ? a.mask + b * T_len : nullptr, T_len, tid);
  cp_async_wait<0>();
  __syncthreads();

  const int row0 = 16 * warp;
  const bool active = row0 < Tp;
  uint32_t qa[E / 4];  // q of the warp's rows: head h is qa[h S/4 ..], an A fragment
  if (active) {
    uint32_t xa[E / 16][4];
    load_row_tile<E>(xa, X + row0 * RS, lane);
#pragma unroll
    for (int n0 = 0; n0 < 3 * E; n0 += 16) {
      float c[2][4];
      tile_x_wt<E>(c, xa, WQ + n0 * RS, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = n0 + 8 * i;
        if (col < E) {
          qa[col / 4] = pack_bf16(c[i][0], c[i][1]);
          qa[col / 4 + 1] = pack_bf16(c[i][2], c[i][3]);
        } else {
          store_c((col < 2 * E ? K : V) + row0 * RS, RS, col % E, c[i], lane);
        }
      }
    }
  }
  __syncthreads();  // k and v of every row
  if (!active) return;

  const int n_kc = Tp / 16;
  uint32_t aa[E / 16][4];  // att of the warp's rows: the unify product's A fragments
#pragma unroll
  for (int h = 0; h < H; ++h) {
    uint32_t q[S / 4];
#pragma unroll
    for (int j = 0; j < S / 4; ++j) q[j] = qa[h * S / 4 + j];
    const bf16* kh = K + h * S;
    const bf16* vh = V + h * S;
    float m[2] = {-INFINITY, -INFINITY};
    for (int kc = 0; kc < n_kc; ++kc) {  // pass 1: the row max over all keys
      float s[2][4];
      head_scores<S, RS>(s, q, kh, kind, kc, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[i][e]);
      }
    }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
    float l[2] = {0.f, 0.f}, o[S / 8][4];
#pragma unroll
    for (int n = 0; n < S / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    for (int kc = 0; kc < n_kc; ++kc) {  // pass 2: e, its sum, o += bf16(e) . v
      float s[2][4];
      head_scores<S, RS>(s, q, kh, kind, kc, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][e] = exp2_approx(s[i][e] - m[e >> 1]);
          l[e >> 1] += s[i][e];
        }
      }
      uint32_t pa[4], vf[S / 8][2];
      c_to_a(pa, s[0], s[1]);
      ldsm_cols<S>(vf, vh, 16 * kc, lane, RS);
#pragma unroll
      for (int n = 0; n < S / 8; ++n) mma_k16(o[n], pa, vf[n][0], vf[n][1]);
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
#pragma unroll
    for (int n = 0; n < S / 8; ++n) {  // column tile h S/8 + n of att
      const int ct = h * S / 8 + n;
      aa[ct / 2][2 * (ct % 2)] = pack_bf16(o[n][0] / l[0], o[n][1] / l[0]);
      aa[ct / 2][2 * (ct % 2) + 1] = pack_bf16(o[n][2] / l[1], o[n][3] / l[1]);
    }
  }

  // out = bf16(bf16(att . Wu^T) + bf16(bu)), 16 columns a step
  bf16* ob = a.out + b * T_len * E;
#pragma unroll
  for (int n0 = 0; n0 < E; n0 += 16) {
    float c[2][4];
    tile_x_wt<E>(c, aa, WU + n0 * RS, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = n0 + 8 * i + 2 * t;
      const float b0 = round_bf16(bu[col]), b1 = round_bf16(bu[col + 1]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + g + 8 * r;
        if (row < T_len) {
          *reinterpret_cast<uint32_t*>(ob + row * E + col) =
              pack_bf16(round_bf16(c[i][2 * r]) + b0, round_bf16(c[i][2 * r + 1]) + b1);
        }
      }
    }
  }
}

template <int E, int S>
cudaError_t launch(const FwdArgs& a, int M, int B, cudaStream_t stream) {
  const int Tp = pad16(a.T_len);
  const int smem = 2 * Dims<E>::RS * (3 * Tp + 4 * E) + Tp;
  cudaError_t err = cudaFuncSetAttribute(fused_qkv_fwd_mma_kernel<E, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_qkv_fwd_mma_kernel<E, S><<<dim3(B, M), THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

// x, out: bf16 (B, T, E), contiguous, 16-byte aligned. mask: bool (B, T), one
// byte each, or null for all keys valid. wqkv float32 (3E, E) and wu float32
// (E, E), 16-byte aligned; bu float32 (E). 1 <= T <= 256; (E, E / H) one of
// (32, 8), (32, 16), (64, 8). M >= 1 stacked members: x and out (M, B, T, E),
// mask (M, B, T) or null, wqkv (M, 3E, E), wu (M, E, E), bu (M, E), one launch
// for all of them (a member's offsets keep the 16 bytes).
extern "C" int mmsn_fused_qkv_fwd_mma(const void* x, const void* mask, const void* wqkv,
                                      const void* wu, const void* bu, void* out, int M, int B,
                                      int T, int E, int H, void* stream) {
  // M is grid.y: at most 65535
  if (M < 1 || M > 65535 || B < 1 || T < 1 || T > MAX_T || H < 1 || E % H || !aligned(x, 16) ||
      !aligned(out, 16) || !aligned(wqkv, 16) || !aligned(wu, 16)) {
    return cudaErrorInvalidValue;
  }
  FwdArgs a;
  a.x = static_cast<const bf16*>(x);
  a.mask = static_cast<const uint8_t*>(mask);
  a.wqkv = static_cast<const float*>(wqkv);
  a.wu = static_cast<const float*>(wu);
  a.bu = static_cast<const float*>(bu);
  a.out = static_cast<bf16*>(out);
  a.T_len = T;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = E / H;
  if (E == 64 && S == 8) return launch<64, 8>(a, M, B, st);
  if (E == 32 && S == 8) return launch<32, 8>(a, M, B, st);
  if (E == 32 && S == 16) return launch<32, 16>(a, M, B, st);
  return cudaErrorInvalidValue;
}
