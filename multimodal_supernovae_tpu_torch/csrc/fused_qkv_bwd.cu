// The whole SelfAttention backward, for Hopper (sm_90a), CUDA cores only: a
// partial-sum kernel and a reduce kernel.
//
// Replaces the Pallas TPU kernel multimodal_supernovae_tpu/ops/
// qkv_attention.py (_bwd_kernel, reached through the custom_vjp's _qkv_bwd)
// and computes exactly ops/qkv_attention.py:fused_qkv_attention_bwd_plain of
// this package: the forward recomputed from x, the mask and the two weights
// with a plain softmax, then the backward through the head unification, the
// attention and the packed projection, with the JAX kernel's rounding points
// (T is the compute dtype):
//   P = softmax(s) in float32, round(P) for att and dv; att = round(round(P) v);
//   datt = round(g @ Wu); dWu = sum g^T att, dbu = sum g (float32);
//   dP = datt_h . v; dS = round(P * (dP - rowsum(P * dP))), 0 at masked keys;
//   dq = round(dS k), dk = round(dS^T q), dv = round(round(P)^T datt_h);
//   dx = round(dqkv @ Wqkv) with one float32 sum over the 3E contraction;
//   dWqkv = sum dqkv^T x (float32).
// Outputs: dx in T and dWqkv (3E, E), dWu (E, E), dbu (E) in float32, weights
// in a Linear's (out, in) layout.
//
// The weight gradients are sums over all samples. The TPU kernel carries them
// in VMEM across its sequential grid; here blocks run in no order, so the sum
// takes two passes with no atomics and does not depend on the schedule: a
// fixed grid of `blocks` blocks walks the samples b, b + blocks, ..., each
// block adding its samples' contributions into a float32 partial of its own in
// device memory (P = 4 E^2 + E floats), and reduce_partials
// (csrc/reduce_partials.cuh) sums the partials in block order.
//
// Sums across positions inside a sample: dq sums over keys, dk and dv over
// queries. One block holds a whole head of the sample, so thread t first plays
// query t (row max, row sum, then att and D = rowsum(P * dP), then dq: four
// walks over the keys, the scores recomputed in each and never stored), then,
// after a barrier, key t (one walk over the queries with their (max, 1/sum, D)
// read from shared memory, giving dk and dv, which overwrite k and v). Each
// thread owns its outputs; nothing is added atomically. The heads' dx
// contributions accumulate in a (T, E + 1) float32 buffer and are rounded once.
// g is read from device memory where it is needed (a row a thread, or a column
// in the dWu and dbu sums): a fourth whole-sample buffer does not fit.
//
// D of a query row is summed as c0 + rowsum(P o (dP - c0)), c0 = dP of the
// row's highest-scoring key. Where a row's positions are nearly equal (deep
// layers), dP - D cancels and an error of D comes through whole: one running
// float32 sum of P dP, whose terms carry D itself and whose P sum to 1 only
// up to rounding, put dx 2.5x farther from float64 than the plain version on
// the model's own layers and 3.3x on near-equal inputs; around c0 the terms
// are of the size of dP - D and the P's rounding multiplies D - c0, not D. The
// flash kernel's c0, key 0, did worse here: it took the first light-curve
// block's dWqkv from 1.5x to 2.5x; the highest-scoring key's dP carries the
// most weight in D (chip_smoke.py phase grad-probe; PERF.md section 6;
// tests/test_torch_qkv_attention_kernel.py pins it).
//
// What bounds it on this card: CUDA-core work at low occupancy. Per head and
// thread the walks cost about 12 S multiply-adds and 4 exponentials a key; one
// block of 256 threads and up to 190 KB of shared memory runs on an SM.
//
// Stacked members (torch.func.vmap over an ensemble, ops/qkv_attention.py)
// are grid.y of both kernels: member m walks its own B samples (x, mask, g, dx
// (M, B, ...) stacked) with the block count a call for m alone takes, reads
// its own Wqkv and Wu ((M, ...) stacked), writes its own (blocks, P) partials,
// and the reduce sums them in block order into its own row of grads: bitwise
// that call's result.
//
// Shared memory: 4 * (32 E + 6 T S + 2 T (E + 1) + 4 T) bytes.
//
// Plain C interface, loaded with ctypes (kernels/build.py): the entry returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a shape
// or dtype it does not take. It launches on the given stream, does not
// synchronise and allocates nothing.

#include "fused_qkv_common.cuh"
#include "reduce_partials.cuh"

namespace {

using namespace qkv;

template <typename T, int S>
__global__ void __launch_bounds__(THREADS, 1) fused_qkv_bwd_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ mask,
    const float* __restrict__ wqkv, const float* __restrict__ wu, const T* __restrict__ g,
    T* __restrict__ dx, float* __restrict__ partial, int B, int Tn, int E) {
  extern __shared__ __align__(16) float smem[];
  const int H = E / S;
  const int ldx = E + 1;
  float* Ws = smem;            // E x EC staged weight slice
  float* Q = Ws + E * EC;      // Tn x S each, one head
  float* K = Q + Tn * S;       // k -> dk
  float* V = K + Tn * S;       // v -> dv
  float* GH = V + Tn * S;      // datt_h
  float* AT = GH + Tn * S;     // att_h
  float* DQ = AT + Tn * S;     // dq
  float* XS = DQ + Tn * S;     // Tn x ldx: x
  float* DX = XS + Tn * ldx;   // Tn x ldx: dx, summed over heads
  float* VAL = DX + Tn * ldx;  // Tn: 1 where the key is valid
  float* SM = VAL + Tn;        // Tn: row max
  float* SL = SM + Tn;         // Tn: 1 / row sum
  float* SD = SL + Tn;         // Tn: rowsum(P * dP)

  const int t = threadIdx.x;
  const bool row = t < Tn;
  const int64_t m = blockIdx.y;  // the member
  x += m * B * Tn * E;
  g += m * B * Tn * E;
  dx += m * B * Tn * E;
  if (mask != nullptr) mask += m * B * Tn;
  wqkv += m * 3 * E * E;
  wu += m * E * E;
  float* part = partial + (m * gridDim.x + blockIdx.x) * (4 * E * E + E);
  float* p_wqkv = part;               // (3E, E)
  float* p_wu = p_wqkv + 3 * E * E;   // (E, E)
  float* p_bu = p_wu + E * E;         // (E)

  bool first = true;
  for (int b = blockIdx.x; b < B; b += gridDim.x, first = false) {
    const T* xb = x + (int64_t)b * Tn * E;
    const T* gb = g + (int64_t)b * Tn * E;
    __syncthreads();  // the previous sample's buffers are consumed
    for (int idx = t; idx < Tn * E; idx += THREADS)
      XS[(idx / E) * ldx + idx % E] = to_float(xb[idx]);
    if (row) {
      VAL[t] = (mask == nullptr || mask[(int64_t)b * Tn + t]) ? 1.f : 0.f;
      for (int i = 0; i < E; ++i) DX[t * ldx + i] = 0.f;
    }
    for (int o = t; o < E; o += THREADS) {  // dbu
      float s = 0.f;
      for (int r = 0; r < Tn; ++r) s += to_float(gb[r * E + o]);
      p_bu[o] = first ? s : p_bu[o] + s;
    }

#pragma unroll 1
    for (int h = 0; h < H; ++h) {
      // ---- recompute the projection; datt_h = round(g @ Wu[:, head]) --------
      project_head<T, S>(XS, ldx, E, h, t, row, wqkv, Ws, Q, K, V);
      __syncthreads();
      stage<T, true>(wu, E, 0, h * S, E, S, Ws);
      __syncthreads();
      if (row) {
        float acc[S];
        row_dot<S>(gb + t * E, E, Ws, acc);
#pragma unroll
        for (int j = 0; j < S; ++j) GH[t * S + j] = round_to<T>(acc[j]);
      }
      __syncthreads();

      // ---- thread t as query t ---------------------------------------------
      if (row) {
        float q[S], gh[S], r[S];
        load_row<S>(Q + t * S, q);
        load_row<S>(GH + t * S, gh);
        float m = -INFINITY;
        int um = 0;  // the highest-scoring key
        for (int u = 0; u < Tn; ++u) {
          load_row<S>(K + u * S, r);
          const float s = VAL[u] != 0.f ? dot<S>(q, r) : MASK_FILL;
          if (s > m) {
            m = s;
            um = u;
          }
        }
        float l = 0.f;
        for (int u = 0; u < Tn; ++u) {
          load_row<S>(K + u * S, r);
          l += __expf((VAL[u] != 0.f ? dot<S>(q, r) : MASK_FILL) - m);
        }
        const float rl = 1.f / l;
        float acc[S];
#pragma unroll
        for (int j = 0; j < S; ++j) acc[j] = 0.f;
        load_row<S>(V + um * S, r);
        const float c0 = dot<S>(gh, r);  // dP of the highest-scoring key
        float d = 0.f;
        for (int u = 0; u < Tn; ++u) {  // att = round(P) v, D = c0 + rowsum(P * (dP - c0))
          load_row<S>(K + u * S, r);
          const float p = __expf((VAL[u] != 0.f ? dot<S>(q, r) : MASK_FILL) - m) * rl;
          load_row<S>(V + u * S, r);
          axpy<S>(round_to<T>(p), r, acc);
          d = fmaf(p, dot<S>(gh, r) - c0, d);
        }
        d += c0;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          AT[t * S + j] = round_to<T>(acc[j]);
          acc[j] = 0.f;
        }
        for (int u = 0; u < Tn; ++u) {  // dq = dS k
          if (VAL[u] == 0.f) continue;  // dS is zeroed at masked keys
          float kr[S];
          load_row<S>(K + u * S, kr);
          const float p = __expf(dot<S>(q, kr) - m) * rl;
          load_row<S>(V + u * S, r);
          axpy<S>(round_to<T>(p * (dot<S>(gh, r) - d)), kr, acc);
        }
#pragma unroll
        for (int j = 0; j < S; ++j) DQ[t * S + j] = round_to<T>(acc[j]);
        SM[t] = m;
        SL[t] = rl;
        SD[t] = d;
      }
      __syncthreads();

      // ---- thread t as key t: dk = dS^T q, dv = round(P)^T datt_h -----------
      if (row) {
        float k[S], v[S], dk[S], dv[S], r[S];
        load_row<S>(K + t * S, k);
        load_row<S>(V + t * S, v);
#pragma unroll
        for (int j = 0; j < S; ++j) dk[j] = dv[j] = 0.f;
        const bool valid = VAL[t] != 0.f;
        for (int u = 0; u < Tn; ++u) {  // u: the query
          load_row<S>(Q + u * S, r);
          const float s = valid ? dot<S>(r, k) : MASK_FILL;
          const float p = __expf(s - SM[u]) * SL[u];
          float gr[S];
          load_row<S>(GH + u * S, gr);
          if (valid) axpy<S>(round_to<T>(p * (dot<S>(gr, v) - SD[u])), r, dk);
          axpy<S>(round_to<T>(p), gr, dv);
        }
#pragma unroll
        for (int j = 0; j < S; ++j) {  // own rows: no other thread reads them now
          K[t * S + j] = round_to<T>(dk[j]);
          V[t * S + j] = round_to<T>(dv[j]);
        }
      }
      __syncthreads();

      // ---- sums over the sample's positions into the block's partial --------
      for (int idx = t; idx < E * S; idx += THREADS) {  // dWu[o][head] = g^T att_h
        const int o = idx / S, j = idx % S;
        float s = 0.f;
        for (int r = 0; r < Tn; ++r) s = fmaf(to_float(gb[r * E + o]), AT[r * S + j], s);
        float* p = p_wu + o * E + h * S + j;
        *p = first ? s : *p + s;
      }
      for (int idx = t; idx < 3 * S * E; idx += THREADS) {  // dWqkv[head rows] = dqkv_h^T x
        const int pt = idx / (S * E), j = (idx / E) % S, i = idx % E;
        const float* D = pt == 0 ? DQ : pt == 1 ? K : V;
        float s = 0.f;
        for (int r = 0; r < Tn; ++r) s = fmaf(D[r * S + j], XS[r * ldx + i], s);
        float* p = p_wqkv + (pt * E + h * S + j) * E + i;
        *p = first ? s : *p + s;
      }

      // ---- dx += dq Wq[head] + dk Wk[head] + dv Wv[head], EC columns a pass --
#pragma unroll 1
      for (int pt = 0; pt < 3; ++pt) {
        const float* D = pt == 0 ? DQ : pt == 1 ? K : V;
#pragma unroll 1
        for (int c0 = 0; c0 < E; c0 += EC) {
          __syncthreads();
          stage<T, true>(wqkv, E, pt * E + h * S, c0, S, EC, Ws);
          __syncthreads();
          if (row) {
            float acc[EC];
            row_dot<EC>(D + t * S, S, Ws, acc);
#pragma unroll
            for (int j = 0; j < EC; ++j) DX[t * ldx + c0 + j] += acc[j];
          }
        }
      }
    }
    if (row) {
      T* dxr = dx + ((int64_t)b * Tn + t) * E;
      for (int i = 0; i < E; ++i) dxr[i] = from_float<T>(DX[t * ldx + i]);
    }
  }
}

template <typename T, int S>
cudaError_t launch(const void* x, const void* mask, const float* wqkv, const float* wu,
                   const void* g, void* dx, float* partial, float* grads, int M, int B,
                   int Tn, int E, int blocks, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)E * EC + 6 * (size_t)Tn * S +
                                       2 * (size_t)Tn * (E + 1) + 4 * (size_t)Tn);
  cudaError_t err = cudaFuncSetAttribute(fused_qkv_bwd_kernel<T, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  fused_qkv_bwd_kernel<T, S><<<dim3(blocks, M), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(mask), wqkv, wu,
      static_cast<const T*>(g), static_cast<T*>(dx), partial, B, Tn, E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int P = 4 * E * E + E;
  return partials::reduce(partial, blocks, P, grads, stream, M, (int64_t)blocks * P, P);
}

template <typename T>
cudaError_t launch_s(int S, const void* x, const void* mask, const float* wqkv,
                     const float* wu, const void* g, void* dx, float* partial, float* grads,
                     int M, int B, int Tn, int E, int blocks, cudaStream_t stream) {
  switch (S) {
    case 8:
      return launch<T, 8>(x, mask, wqkv, wu, g, dx, partial, grads, M, B, Tn, E, blocks,
                          stream);
    case 16:
      return launch<T, 16>(x, mask, wqkv, wu, g, dx, partial, grads, M, B, Tn, E, blocks,
                           stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, g, dx: contiguous (B, T, E)). mask: bool
// (B, T), one byte each, or null. wqkv float32 (3E, E), wu float32 (E, E).
// partial is float32 (blocks, P) scratch, P = 4 E^2 + E, with 1 <= blocks <= B;
// grads is float32 (P): dwqkv (3E, E), dwu (E, E), dbu (E). 1 <= T <= 256, E a
// multiple of 32, E / H in {8, 16}. M >= 1 stacked members: x, g, dx (M, B, T,
// E), mask (M, B, T) or null, wqkv (M, 3E, E), wu (M, E, E), partial (M,
// blocks, P) and grads (M, P), one launch of each kernel for all of them.
extern "C" int mmsn_fused_qkv_bwd(const void* x, const void* mask, const void* wqkv,
                                  const void* wu, const void* g, void* dx, void* partial,
                                  void* grads, int M, int B, int T, int E, int H, int dtype,
                                  int blocks, void* stream) {
  // M is grid.y: at most 65535
  if (M < 1 || M > 65535 || B < 1 || T < 1 || T > THREADS || E < EC || E % EC || H < 1 ||
      E % H || blocks < 1 || blocks > B) {
    return cudaErrorInvalidValue;
  }
  const float* w = static_cast<const float*>(wqkv);
  const float* u = static_cast<const float*>(wu);
  float* part = static_cast<float*>(partial);
  float* out = static_cast<float*>(grads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_s<float>(E / H, x, mask, w, u, g, dx, part, out, M, B, T, E, blocks, st);
    case 1:
      return launch_s<__nv_bfloat16>(E / H, x, mask, w, u, g, dx, part, out, M, B, T, E,
                                     blocks, st);
    default:
      return cudaErrorInvalidValue;
  }
}
