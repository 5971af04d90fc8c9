// Fused row-local tail of a post-norm transformer block, backward, for Hopper
// (sm_90a), CUDA cores only: a partial-sum kernel and a reduce kernel.
//
// Replaces the Pallas TPU kernel multimodal_supernovae_tpu/ops/fused_block.py
// (_ffn_bwd_kernel, reached through the custom_vjp's _ffn_bwd) and computes
// exactly ops/fused_block.py:fused_ffn_block_bwd_plain of this package: the
// forward of csrc/fused_ffn_fwd.cu recomputed from att, x and the parameters,
// then the backward through LN2, the FFN, LN1 and the head unification with
// the JAX kernel's rounding points (df, dhc, da rounded to T before their
// products; dr2, dh, dr1 kept in float32 for the bias sums and the residual
// path; the ReLU gradient taken where the rounded pre-activation is > 0).
// Outputs: datt and dx in T, and the ten parameter gradients in float32,
// weights in a Linear's (out, in) layout.
//
// The parameter gradients are sums over all N rows. The TPU kernel carries
// them in VMEM across its sequential grid; here blocks run in no order, so the
// sum takes two passes with no atomics, and the result does not depend on the
// schedule: a fixed grid of `blocks` blocks (one per SM) walks the row tiles
// b, b + blocks, ..., each block adding its tiles' contributions into a
// float32 partial of its own in device memory (P = E^2 + 2EF + 6E + F floats,
// 19.8 MB at 132 blocks, E = 64, F = 256); reduce_partials
// (csrc/reduce_partials.cuh) then sums the partials in block order.
//
// Per tile of 32 rows, everything stays in shared memory: att, xhat1 (later
// da), y1, h (later dh, dhc), xhat2 (later df), dr2 (later dy1, dr1) and each
// row's two rstd. Products are those of the forward (warp per 4 rows, lane per
// column, staged weight chunks); the weight gradients are outer products over
// the tile's rows (warp per 4 output rows, lane per column) added into the
// block's partial; bias and LayerNorm gradients are column sums. Rows past N
// get a zero cotangent, so they add nothing, and are not stored.
//
// Stacked members (torch.func.vmap over an ensemble, ops/fused_block.py) are
// grid.y of both kernels: member m walks its own N rows with the block count a
// call for m alone takes, reads its own ten parameters (each stacked (M, ...)
// contiguous), writes its own (blocks, P) partials, and the reduce sums them
// in block order into its own row of grads: bitwise that call's result.
//
// What bounds it on this card: at the light-curve shape (N = 51,200, E = 64,
// F = 256) a launch does the recompute plus 2*N*(4EF + 2E^2) = 11.3 GFLOP in
// all against 66 MB (float32) of activations and cotangent, plus the partials'
// read-modify-write, which stays in the 50 MB L2 for the most part. In float32
// that is CUDA-core bound (67 TFLOP/s: 0.17 ms). Shared memory:
// 4 * (32 * (5E + F) + 64 + 32 * 257) bytes (107 KB at E = 64, F = 256).
// The kernel may take 255 registers a thread, so one block (8 warps) runs on
// an SM: held to 128 registers for two blocks an SM, it spilled in its inner
// loops and ran slower (PERF.md, section 6).
//
// Plain C interface, loaded with ctypes (kernels/build.py): the entry returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a shape
// or dtype it does not take. It launches on the given stream, does not
// synchronise and allocates nothing.

#include "fused_ffn_common.cuh"
#include "reduce_partials.cuh"

namespace {

using namespace ffn;

// part[c] (first tile: =, else +=) sum over the tile's rows of a[r][c]
// (times b[r][c] when b is given), for c < n; rows are ld floats apart.
__device__ __forceinline__ void colsum(const float* a, const float* b, int ld, int n,
                                       float* part, bool first) {
  for (int c = threadIdx.x; c < n; c += THREADS) {
    float s = 0.f;
#pragma unroll 8
    for (int r = 0; r < ROWS; ++r) s += b ? a[r * ld + c] * b[r * ld + c] : a[r * ld + c];
    part[c] = first ? s : part[c] + s;
  }
}

// part[o][c] (first tile: =, else +=) sum over the tile's rows of
// D[r][o] * X[r][c], for the warp's 4 output rows o = ob + 4*warp + i and the
// lane's columns c = c0 + lane + 32 j; part is (O, C) row-major.
template <int NC>
__device__ __forceinline__ void outer_pass(const float* D, int ldd, const float* X, int ldx,
                                           int C, int ob, int c0, float* part, bool first) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int o = ob + 4 * warp;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int r = 0; r < ROWS; ++r) {
    const float4 d = *reinterpret_cast<const float4*>(D + r * ldd + o);  // broadcast
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float xv = X[r * ldx + c0 + lane + 32 * j];
      acc[0][j] = fmaf(d.x, xv, acc[0][j]);
      acc[1][j] = fmaf(d.y, xv, acc[1][j]);
      acc[2][j] = fmaf(d.z, xv, acc[2][j]);
      acc[3][j] = fmaf(d.w, xv, acc[3][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      float* p = part + (int64_t)(o + i) * C + c0 + lane + 32 * j;
      *p = first ? acc[i][j] : *p + acc[i][j];
    }
  }
}

// The weight gradient part (O x C) of the tile: all output rows in groups of
// 32 (8 warps x 4), all columns in passes of at most MAX_COLS.
__device__ void outer(const float* D, int ldd, int O, const float* X, int ldx, int C,
                      float* part, bool first) {
  for (int ob = 0; ob < O; ob += 4 * (THREADS / 32)) {
    for (int c0 = 0; c0 < C; c0 += MAX_COLS) {
      switch (min(C - c0, MAX_COLS) / 32) {
        case 1: outer_pass<1>(D, ldd, X, ldx, C, ob, c0, part, first); break;
        case 2: outer_pass<2>(D, ldd, X, ldx, C, ob, c0, part, first); break;
        case 3: outer_pass<3>(D, ldd, X, ldx, C, ob, c0, part, first); break;
        case 4: outer_pass<4>(D, ldd, X, ldx, C, ob, c0, part, first); break;
        case 5: outer_pass<5>(D, ldd, X, ldx, C, ob, c0, part, first); break;
        case 6: outer_pass<6>(D, ldd, X, ldx, C, ob, c0, part, first); break;
        case 7: outer_pass<7>(D, ldd, X, ldx, C, ob, c0, part, first); break;
        default: outer_pass<8>(D, ldd, X, ldx, C, ob, c0, part, first); break;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) fused_ffn_bwd_kernel(
    const T* __restrict__ att, const T* __restrict__ x, const float* __restrict__ wu,
    const float* __restrict__ bu, const float* __restrict__ g1, const float* __restrict__ b1,
    const float* __restrict__ wf1, const float* __restrict__ bf1,
    const float* __restrict__ wf2, const float* __restrict__ bf2,
    const float* __restrict__ g2, const float* __restrict__ b2, const T* __restrict__ g,
    T* __restrict__ datt, T* __restrict__ dx, float* __restrict__ partial, int N, int E,
    int F, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* ATT = smem;            // ROWS x E: att
  float* XH1 = ATT + ROWS * E;  // r1 -> xhat1 -> da
  float* Y1 = XH1 + ROWS * E;   // y1
  float* Hb = Y1 + ROWS * E;    // ROWS x F: h -> dh -> dhc
  float* XH2 = Hb + ROWS * F;   // r2 -> xhat2 -> df
  float* DR2 = XH2 + ROWS * E;  // dy2 -> dr2 -> dy1 -> dr1
  float* RSTD1 = DR2 + ROWS * E;
  float* RSTD2 = RSTD1 + ROWS;
  float* Ws = RSTD2 + ROWS;     // KC x WS_LD
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // member blockIdx.y's rows and parameters, formed at each use (member_slice)
  const int64_t NE = (int64_t)N * E;
  using partials::member_slice;

  const int64_t P = E * E + 2 * E * F + 6 * E + F;
  float* part = partial + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * P;
  // the parameters' order: wu, bu, g1, b1, wf1, bf1, wf2, bf2, g2, b2
  float* p_wu = part;
  float* p_bu = p_wu + E * E;
  float* p_g1 = p_bu + E;
  float* p_b1 = p_g1 + E;
  float* p_wf1 = p_b1 + E;
  float* p_bf1 = p_wf1 + F * E;
  float* p_wf2 = p_bf1 + F;
  float* p_bf2 = p_wf2 + E * F;
  float* p_g2 = p_bf2 + E;
  float* p_b2 = p_g2 + E;

  const int tiles = (N + ROWS - 1) / ROWS;
  bool first = true;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, first = false) {
    const int64_t row0 = (int64_t)tile * ROWS;
    __syncthreads();  // the previous tile's buffers are consumed
    const T* att_m = member_slice(att, NE);
    for (int idx = threadIdx.x; idx < ROWS * E; idx += THREADS) {
      const int64_t row = row0 + idx / E;
      ATT[idx] = row < N ? to_float(att_m[row0 * E + idx]) : 0.f;
    }

    // ---- recompute the forward ----------------------------------------------
    const T* x_m = member_slice(x, NE);
    const float* bu_m = member_slice(bu, E);
    gemm<T, true>(ATT, E, E, member_slice(wu, E * E), E, Ws, [&](int r, int o, float acc) {
      const int64_t row = row0 + r;
      const float xv = row < N ? to_float(x_m[row * E + o]) : 0.f;
      const float a = round_to<T>(round_to<T>(acc) + round_to<T>(bu_m[o]));
      XH1[r * E + o] = round_to<T>(a + xv);
    });
    __syncthreads();
    const float* g1_m = member_slice(g1, E);
    const float* b1_m = member_slice(b1, E);
#pragma unroll 1
    for (int i = 0; i < RPW; ++i) {  // LN1: xhat1 in place, y1
      const int r = warp * RPW + i;
      float v[MAX_EJ];
      const float2 st = ln_stats(XH1 + r * E, E, eps, v);
#pragma unroll
      for (int j = 0; j < MAX_EJ; ++j) {
        if (32 * j < E) {
          const int c = lane + 32 * j;
          const float xh = (v[j] - st.x) * st.y;
          XH1[r * E + c] = xh;
          Y1[r * E + c] = round_to<T>(xh * g1_m[c] + b1_m[c]);
        }
      }
      if (lane == 0) RSTD1[r] = st.y;
    }
    const float* bf1_m = member_slice(bf1, F);
    gemm<T, true>(Y1, E, E, member_slice(wf1, F * E), F, Ws, [&](int r, int o, float acc) {
      Hb[r * F + o] = fmaxf(round_to<T>(round_to<T>(acc) + round_to<T>(bf1_m[o])), 0.f);
    });
    const float* bf2_m = member_slice(bf2, E);
    gemm<T, true>(Hb, F, F, member_slice(wf2, E * F), E, Ws, [&](int r, int o, float acc) {
      const float f = round_to<T>(round_to<T>(acc) + round_to<T>(bf2_m[o]));
      XH2[r * E + o] = round_to<T>(f + Y1[r * E + o]);
    });
    __syncthreads();
    const T* g_m = member_slice(g, NE);
#pragma unroll 1
    for (int i = 0; i < RPW; ++i) {  // LN2: xhat2 in place; dy2 = g
      const int r = warp * RPW + i;
      const int64_t row = row0 + r;
      float v[MAX_EJ];
      const float2 st = ln_stats(XH2 + r * E, E, eps, v);
#pragma unroll
      for (int j = 0; j < MAX_EJ; ++j) {
        if (32 * j < E) {
          const int c = lane + 32 * j;
          XH2[r * E + c] = (v[j] - st.x) * st.y;
          DR2[r * E + c] = row < N ? to_float(g_m[row * E + c]) : 0.f;
        }
      }
      if (lane == 0) RSTD2[r] = st.y;
    }
    __syncthreads();

    // ---- LN2 backward -------------------------------------------------------
    colsum(DR2, XH2, E, E, p_g2, first);
    colsum(DR2, nullptr, E, E, p_b2, first);
    __syncthreads();
    const float* g2_m = member_slice(g2, E);
#pragma unroll 1
    for (int i = 0; i < RPW; ++i) {  // dr2 in place, df = round(dr2)
      const int r = warp * RPW + i;
      float dy[MAX_EJ], xh[MAX_EJ];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < MAX_EJ; ++j) {
        if (32 * j < E) {
          const int c = lane + 32 * j;
          dy[j] = DR2[r * E + c] * g2_m[c];
          xh[j] = XH2[r * E + c];
          s1 += dy[j];
          s2 += dy[j] * xh[j];
        }
      }
      const float m1 = warp_sum(s1) / E;
      const float m2 = warp_sum(s2) / E;
      const float rstd = RSTD2[r];
#pragma unroll
      for (int j = 0; j < MAX_EJ; ++j) {
        if (32 * j < E) {
          const int c = lane + 32 * j;
          const float dr = rstd * (dy[j] - m1 - xh[j] * m2);
          DR2[r * E + c] = dr;
          XH2[r * E + c] = round_to<T>(dr);
        }
      }
    }
    __syncthreads();

    // ---- FFN backward -------------------------------------------------------
    colsum(DR2, nullptr, E, E, p_bf2, first);
    outer(XH2, E, E, Hb, F, F, p_wf2, first);  // dWf2 (E, F) = df^T h
    gemm<T, false>(XH2, E, E, member_slice(wf2, E * F), F, Ws, [&](int r, int o, float acc) {
      float* h = Hb + r * F + o;  // dh = df @ Wf2 where h > 0
      *h = *h > 0.f ? acc : 0.f;
    });
    __syncthreads();
    colsum(Hb, nullptr, F, F, p_bf1, first);  // dbf1 from unrounded dh
    __syncthreads();
    if (!std::is_same<T, float>::value) {
      for (int idx = threadIdx.x; idx < ROWS * F; idx += THREADS) Hb[idx] = round_to<T>(Hb[idx]);
      __syncthreads();
    }
    outer(Hb, F, F, Y1, E, E, p_wf1, first);  // dWf1 (F, E) = dhc^T y1
    gemm<T, false>(Hb, F, F, member_slice(wf1, F * E), E, Ws, [&](int r, int o, float acc) {
      DR2[r * E + o] += acc;  // dy1 = dr2 + dhc @ Wf1
    });
    __syncthreads();

    // ---- LN1 backward -------------------------------------------------------
    colsum(DR2, XH1, E, E, p_g1, first);
    colsum(DR2, nullptr, E, E, p_b1, first);
    __syncthreads();
    const float* g1_b = member_slice(g1, E);
    T* dx_m = member_slice(dx, NE);
#pragma unroll 1
    for (int i = 0; i < RPW; ++i) {  // dr1 in place, da = round(dr1), dx
      const int r = warp * RPW + i;
      const int64_t row = row0 + r;
      float dy[MAX_EJ], xh[MAX_EJ];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < MAX_EJ; ++j) {
        if (32 * j < E) {
          const int c = lane + 32 * j;
          dy[j] = DR2[r * E + c] * g1_b[c];
          xh[j] = XH1[r * E + c];
          s1 += dy[j];
          s2 += dy[j] * xh[j];
        }
      }
      const float m1 = warp_sum(s1) / E;
      const float m2 = warp_sum(s2) / E;
      const float rstd = RSTD1[r];
#pragma unroll
      for (int j = 0; j < MAX_EJ; ++j) {
        if (32 * j < E) {
          const int c = lane + 32 * j;
          const float dr = rstd * (dy[j] - m1 - xh[j] * m2);
          DR2[r * E + c] = dr;
          XH1[r * E + c] = round_to<T>(dr);
          if (row < N) dx_m[row * E + c] = from_float<T>(dr);
        }
      }
    }
    __syncthreads();

    // ---- head unification backward -----------------------------------------
    colsum(DR2, nullptr, E, E, p_bu, first);
    outer(XH1, E, E, ATT, E, E, p_wu, first);  // dWu (E, E) = da^T att
    T* datt_m = member_slice(datt, NE);
    gemm<T, false>(XH1, E, E, member_slice(wu, E * E), E, Ws, [&](int r, int o, float acc) {
      const int64_t row = row0 + r;
      if (row < N) datt_m[row * E + o] = from_float<T>(acc);  // da @ Wu
    });
  }
}

template <typename T>
cudaError_t launch(const void* att, const void* x, const float* const* p, const void* g,
                   void* datt, void* dx, float* partial, float* grads, int M, int N, int E,
                   int F, int blocks, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)ROWS * (5 * E + F) + 2 * ROWS + KC * WS_LD);
  cudaError_t err = cudaFuncSetAttribute(fused_ffn_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  fused_ffn_bwd_kernel<T><<<dim3(blocks, M), THREADS, smem, stream>>>(
      static_cast<const T*>(att), static_cast<const T*>(x), p[0], p[1], p[2], p[3], p[4],
      p[5], p[6], p[7], p[8], p[9], static_cast<const T*>(g), static_cast<T*>(datt),
      static_cast<T*>(dx), partial, N, E, F, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int P = E * E + 2 * E * F + 6 * E + F;
  return partials::reduce(partial, blocks, P, grads, stream, M, (int64_t)blocks * P, P);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (att, x, g, datt, dx: contiguous (N, E));
// the ten parameters as in mmsn_fused_ffn_fwd. partial is float32 (blocks, P)
// scratch, P = E^2 + 2EF + 6E + F, with 1 <= blocks <= ceil(N / 32); grads is
// float32 (P): dwu (E, E), dbu, dg1, db1 (E each), dwf1 (F, E), dbf1 (F),
// dwf2 (E, F), dbf2, dg2, db2 (E each), in the order of the parameters. M >= 1
// stacked members: att, x, g, datt, dx (M, N, E), every parameter (M, ...),
// partial (M, blocks, P) and grads (M, P), one launch of each kernel for all.
extern "C" int mmsn_fused_ffn_bwd(const void* att, const void* x, const void* wu,
                                  const void* bu, const void* g1, const void* b1,
                                  const void* wf1, const void* bf1, const void* wf2,
                                  const void* bf2, const void* g2, const void* b2,
                                  const void* g, void* datt, void* dx, void* partial,
                                  void* grads, int M, int N, int E, int F, int dtype,
                                  int blocks, float eps, void* stream) {
  // M is grid.y: at most 65535
  if (M < 1 || M > 65535 || N < 1 || E < 32 || F < 32 || E % 32 || F % 32 ||
      E > 32 * MAX_EJ || blocks < 1 || blocks > (N + ROWS - 1) / ROWS) {
    return cudaErrorInvalidValue;
  }
  const float* p[10] = {
      static_cast<const float*>(wu), static_cast<const float*>(bu),
      static_cast<const float*>(g1), static_cast<const float*>(b1),
      static_cast<const float*>(wf1), static_cast<const float*>(bf1),
      static_cast<const float*>(wf2), static_cast<const float*>(bf2),
      static_cast<const float*>(g2), static_cast<const float*>(b2)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* out = static_cast<float*>(grads);
  switch (dtype) {
    case 0:
      return launch<float>(att, x, p, g, datt, dx, part, out, M, N, E, F, blocks, eps, st);
    case 1:
      return launch<__nv_bfloat16>(att, x, p, g, datt, dx, part, out, M, N, E, F, blocks,
                                   eps, st);
    default:
      return cudaErrorInvalidValue;
  }
}
