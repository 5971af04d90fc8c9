// Fused row-local tail of a post-norm transformer block, backward, float32, on
// Hopper's tensor cores (sm_90a, mma.sync in 3xTF32): a row kernel, one
// weight-gradient kernel launched three times, and the reduce kernel of
// csrc/reduce_partials.cuh.
//
// Replaces the Pallas TPU kernel multimodal_supernovae_tpu/ops/fused_block.py
// (_ffn_bwd_kernel, reached through the custom_vjp's _ffn_bwd) on the float32
// path, and computes ops/fused_block.py:fused_ffn_block_bwd_plain of this
// package over float32 (N, E) rows, as csrc/fused_ffn_bwd.cu (the CUDA-core
// kernel, which also takes bfloat16) does: the forward of
// csrc/fused_ffn_fwd_mma.cu recomputed from att, x and the parameters, then
//   dr2 = LN2'(g);  dh = (dr2 . Wf2) where h > 0;  dy1 = dr2 + dh . Wf1;
//   dr1 = LN1'(dy1);  datt = dr1 . Wu;  dx = dr1;
//   dWf2 = dr2^T h, dbf2 = sum dr2;  dWf1 = dh^T y1, dbf1 = sum dh;
//   dWu = dr1^T att, dbu = sum dr1;  dg2, db2, dg1, db1 the LayerNorm sums,
// weights in a Linear's (out, in) layout. Every product, the recompute's
// three and the backward's six, is 3xTF32 with float32 accumulation
// (csrc/tf32x3.cuh): about float32 accuracy on the tensor cores.
//
// What bounds it on this card: at the light-curve shape (N = 51,200, E = 64,
// F = 256) a call does 2 N (3 E^2 + 6 E F) = 11.32 GFLOP, three TF32 passes of
// it at 495 TFLOP/s: 0.0686 ms, against 65.8 MB of inputs and outputs at 3.35
// TB/s: 0.0197 ms. Operations bound it. The design adds a scratch round trip:
// the row kernel writes dr2, y1 (N x E each), h and dh (N x F each), 131 MB at
// LC, and the weight-gradient kernel reads them back: 262 MB, 0.078 ms at the
// memory's rate, beyond the bound (a later design keeps them on chip).
//
// Stage 1, the row kernel (fused_ffn_bwd_mma_rows). A block of 4 warps walks
// row tiles of 64 rows (tile b, b + blocks, ...); warp w owns rows 16w ..
// 16w + 15 of the tile in every product and row pass, as in the forward. Per
// warp: a = att . Wu^T, bias, residual and LN1 on the C fragments (xhat1 kept
// in shared memory in fragment order, rstd1 in registers), y1 to the warp's
// shared rows and to scratch; per 32-column chunk of F, h = relu(y1 . Wf1^T +
// bf1) to scratch, its relu' bits to shared memory, f += h . Wf2^T; LN2 on f,
// then its backward with the cotangent (two passes over g) gives dr2 in the C
// fragments, to shared rows and scratch; per chunk, dh = dr2 . Wf2 masked by
// the bits, to scratch, and dy1 (started at dr2) += dh . Wf1; LN1's backward
// gives dr1, written as dx, and datt = dr1 . Wu. The three backward products
// take their weight as it is stored, k rows of n (load_b_kn). The LayerNorm
// sums are column sums of the warp's 16 rows (three shuffles), added into a
// per-warp row of shared memory across tiles and summed over the warps in
// order at the end: one float32 partial a block.
//
// Stage 2, the weight-gradient kernel (fused_ffn_bwd_mma_wgrad), launched for
// (D, X) = (dr2, h), (dh, y1) and (dx, att): dW = D^T X and colsum(D). The
// grid is (output tiles, splits); a block of wm x wn warps (each a 32 x 32
// piece of the output) owns a (32 wm) x (32 wn) output tile and the row tiles
// of its split, 32 rows at a time: D's and X's rows are staged split into
// TF32 hi and lo (k rows of m, of n), then 4 k steps of 3xTF32 mma.sync. The
// blocks of the first output column also sum D's columns, each thread its
// own 4 columns, combined in thread order. Each split writes a float32
// partial; reduce_partials sums them in split order. Rows past N are zero on
// load in both stages and are never stored: deterministic, no atomics.
//
// Stacked members (torch.func.vmap over an ensemble, ops/fused_block.py) are
// grid.y of the row kernel and the reduces and grid.z of the weight-gradient
// kernel: member m reads and writes its own rows, scratch and parameters (each
// stacked (M, ...) contiguous) and its own partials, with the block and split
// counts a call for m alone takes, so its results are bitwise that call's.
//
// Shared memory, stage 1, floats: 64 (E + 4) [att, y1, dr2, dr1 rows] + 64
// (32 + 4) [h, dh chunk] + 64 E [xhat1] + 2 max(E (E + 8) [Wu], 32 (E + 4) +
// E (32 + 4) [Wf1, Wf2 chunk], E (32 + 8) + 32 (E + 8) [the same, k rows of n])
// [hi and lo] + 16 E [LayerNorm sums]; then 8 F bytes of relu' bits. That is
// 88,064 bytes at (E, F) = (64, 256) (two blocks an SM) and 227,328 at
// (128, 512). Stage 2: 8 * 32 (32 wm + 8 + 32 wn + 8) bytes, 86,016 at most.
//
// ptxas on the card (sm_90a, -O3): the row kernel 194 registers at E = 64,
// 205 at E = 96, 254 at E = 128; the weight-gradient kernel 104; the reduce
// 32; no spills, one barrier each.
//
// Plain C interface, loaded with ctypes (kernels/build.py): the entry returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a shape
// or alignment it does not take. It launches on the given stream, does not
// synchronise and allocates nothing: the caller gives every scratch buffer.

#include "tf32x3.cuh"
#include "reduce_partials.cuh"

namespace {

using namespace tf32x3;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;  // rows of a row tile
constexpr int FC = 32;            // hidden columns a chunk
constexpr int HT = FC / 8;        // n tiles of a chunk
constexpr int WROWS = 32;         // rows of a weight-gradient step
constexpr int MAX_WARPS = 16;     // warps of a weight-gradient block

struct Args {  // member 0's pointers; member m's are (M, ...) stacked after them
  const float *att, *x, *wu, *bu, *g1, *b1, *wf1, *bf1, *wf2, *bf2, *g2, *b2, *g;
  float *datt, *dx, *grads;
  float *dr2, *h, *dh, *y1;  // scratch: (N, E), (N, F), (N, F), (N, E)
  float* ln_partial;         // (2, blocks, 2E): (dg1, db1), then (dg2, db2)
  float* w_partial;          // (splits, E F + F)
  int M, N, F, blocks, splits;
  float eps;
};

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int E>
struct RowLayout {
  static constexpr int XLD = E + PAD;                           // att, y1, dr2, dr1 rows
  static constexpr int HLD = FC + PAD;                          // h, dh rows of a chunk
  static constexpr int WU = E * (E + PAD_KN);                   // Wu, either way round
  static constexpr int FWD = FC * XLD + E * HLD;                // Wf1, Wf2 chunks, n rows of k
  static constexpr int BWD = E * (FC + PAD_KN) + FC * (E + PAD_KN);  // the same, k rows of n
  static constexpr int WS = 2 * cmax(WU, cmax(FWD, BWD));       // hi and lo
  static constexpr int FLOATS = ROWS * XLD + ROWS * HLD + ROWS * E + WS + WARPS * 4 * E;
  static size_t bytes(int F) { return 4 * (size_t)FLOATS + 2 * (size_t)WARPS * (F / FC) * 32; }
};

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Bias and residual into the C fragments v of the warp's rows (g, g + 8),
// then v = xhat, the LayerNorm's normalised rows; rstd[half] of row g + 8 half.
template <int NT, typename Res>
__device__ __forceinline__ void residual_norm(float (&v)[NT][4], const float* __restrict__ bias,
                                              float eps, int t, float (&rstd)[2], Res res) {
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
  float mean[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mean[h] = quad_sum(s[h]) / (8 * NT);
    rstd[h] = rsqrtf(quad_sum(ss[h]) / (8 * NT) - mean[h] * mean[h] + eps);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[j][q] = (v[j][q] - mean[q >> 1]) * rstd[q >> 1];
  }
}

// dst[c], dst[c + 1] += the sums of v over the warp's 16 rows: v holds the
// lane's two rows (g, g + 8) summed; the 8 lanes of one t hold the same
// columns. A fixed shuffle tree: deterministic.
__device__ __forceinline__ void add_column_sums(float* dst, int c, float2 v, int lane) {
#pragma unroll
  for (int m = 4; m < 32; m <<= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, m);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, m);
  }
  if (lane < 4) {
    dst[c] += v.x;
    dst[c + 1] += v.y;
  }
}

// The C fragments v of the warp's rows to its shared rows s (ld a row) and, for
// rows below N, to the (N, ldg) matrix dst at columns c0 + ...
template <int NT>
__device__ __forceinline__ void store_rows(const float (&v)[NT][4], float* s, int ld, float* dst,
                                           int64_t ldg, int c0, int64_t ra, int N, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = 8 * j + 2 * t;
    if (s) {
      st2(s + g * ld + c, v[j][0], v[j][1]);
      st2(s + (g + 8) * ld + c, v[j][2], v[j][3]);
    }
    if (ra < N) st2(dst + ra * ldg + c0 + c, v[j][0], v[j][1]);
    if (ra + 8 < N) st2(dst + (ra + 8) * ldg + c0 + c, v[j][2], v[j][3]);
  }
}

template <int E>
__global__ void __launch_bounds__(THREADS, 1) fused_ffn_bwd_mma_rows(const Args a) {
  using L = RowLayout<E>;
  constexpr int NT = E / 8;  // n tiles of an E-wide output
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;                          // ROWS x XLD: att -> y1 -> dr2 -> dr1
  float* Hs = Xs + ROWS * L::XLD;            // ROWS x HLD: h, then dh, of a chunk
  float* XH = Hs + ROWS * L::HLD;            // xhat1, 16 E a warp in fragment order
  uint32_t* Ws = reinterpret_cast<uint32_t*>(XH + ROWS * E);
  float* LNs = reinterpret_cast<float*>(Ws + L::WS);  // WARPS x (dg1, db1, dg2, db2)
  uint16_t* Ms = reinterpret_cast<uint16_t*>(LNs + WARPS * 4 * E);  // relu' bits
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int N = a.N, F = a.F;
  // member blockIdx.y's rows, scratch, parameters and LayerNorm partials, each
  // formed where it is used (member_slice)
  using partials::member_slice;
  const int64_t NE = (int64_t)N * E, NF = (int64_t)N * F;
  float* Xw = Xs + warp * 16 * L::XLD;
  float* Hw = Hs + warp * 16 * L::HLD;
  float* XHw = XH + warp * 16 * E;
  float* LNw = LNs + warp * 4 * E;
  uint16_t* Mw = Ms + warp * (F / FC) * 32;
  // forward chunk: Wf1 rows c0 .., then Wf2 columns c0 .., n rows of k
  uint32_t* W1hi = Ws;
  uint32_t* W1lo = W1hi + FC * L::XLD;
  uint32_t* W2hi = W1lo + FC * L::XLD;
  uint32_t* W2lo = W2hi + E * L::HLD;
  // backward chunk: Wf2 columns c0 .. (E rows of FC), then Wf1 rows c0 .. (FC
  // rows of E), k rows of n
  constexpr int LD2 = FC + PAD_KN, LD1 = E + PAD_KN;
  uint32_t* V2hi = Ws;
  uint32_t* V2lo = V2hi + E * LD2;
  uint32_t* V1hi = V2lo + E * LD2;
  uint32_t* V1lo = V1hi + FC * LD1;
  for (int i = lane; i < 4 * E; i += 32) LNw[i] = 0.f;

  const int tiles = (N + ROWS - 1) / ROWS;
#pragma unroll 1
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t row0 = (int64_t)tile * ROWS;
    const int64_t ra = row0 + warp * 16 + g;  // the lane's rows: ra and ra + 8
    __syncthreads();  // the previous tile is done with Xs and the staged weights
    const float* att = member_slice(a.att, NE);
    for (int idx = threadIdx.x; idx < ROWS * (E / 4); idx += THREADS) {
      const int r = idx / (E / 4);
      const int c = (idx - r * (E / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < N) v = __ldg(reinterpret_cast<const float4*>(att + (row0 + r) * E + c));
      *reinterpret_cast<float4*>(Xs + r * L::XLD + c) = v;
    }
    stage_split<THREADS>(Ws, Ws + L::WU, L::XLD, member_slice(a.wu, E * E), E, E, E);
    __syncthreads();

    // ---- recompute: LN1 -------------------------------------------------------
    float f[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) f[j][0] = f[j][1] = f[j][2] = f[j][3] = 0.f;
    warp_product<NT, E>(f, Xw, L::XLD, Ws, Ws + L::WU, L::XLD, lane);
    float rstd1[2];
    const float* x = member_slice(a.x, NE);
    residual_norm(f, member_slice(a.bu, E), a.eps, t, rstd1, [&](int h, int c) {
      const int64_t row = ra + 8 * h;
      return row < N ? ldg2(x + row * E + c) : make_float2(0.f, 0.f);
    });
    __syncwarp();  // every lane has read its att fragments
    const float* g1 = member_slice(a.g1, E);
    const float* b1 = member_slice(a.b1, E);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 gm = ldg2(g1 + c), bt = ldg2(b1 + c);
#pragma unroll
      for (int q = 0; q < 4; ++q) XHw[(4 * j + q) * 32 + lane] = f[j][q];
      f[j][0] = f[j][0] * gm.x + bt.x;
      f[j][1] = f[j][1] * gm.y + bt.y;
      f[j][2] = f[j][2] * gm.x + bt.x;
      f[j][3] = f[j][3] * gm.y + bt.y;
    }
    store_rows(f, Xw, L::XLD, member_slice(a.y1, NE), E, 0, ra, N, lane);  // y1
    __syncwarp();

    // ---- recompute: the FFN, chunk by chunk, then LN2 --------------------------
#pragma unroll
    for (int j = 0; j < NT; ++j) f[j][0] = f[j][1] = f[j][2] = f[j][3] = 0.f;
#pragma unroll 1
    for (int c0 = 0, ci = 0; c0 < F; c0 += FC, ++ci) {
      __syncthreads();  // every warp is done with the staged weights and its h rows
      stage_split<THREADS>(W1hi, W1lo, L::XLD, member_slice(a.wf1, F * E) + (int64_t)c0 * E,
                           E, FC, E);
      stage_split<THREADS>(W2hi, W2lo, L::HLD, member_slice(a.wf2, E * F) + c0, F, E, FC);
      __syncthreads();
      float hv[HT][4];
#pragma unroll
      for (int j = 0; j < HT; ++j) hv[j][0] = hv[j][1] = hv[j][2] = hv[j][3] = 0.f;
      warp_product<HT, E>(hv, Xw, L::XLD, W1hi, W1lo, L::XLD, lane);
      uint32_t bits = 0;
      const float* bf1 = member_slice(a.bf1, F);
#pragma unroll
      for (int j = 0; j < HT; ++j) {
        const float2 b = ldg2(bf1 + c0 + 8 * j + 2 * t);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          hv[j][q] = fmaxf(hv[j][q] + ((q & 1) ? b.y : b.x), 0.f);
          bits |= (uint32_t)(hv[j][q] > 0.f) << (4 * j + q);
        }
      }
      Mw[ci * 32 + lane] = (uint16_t)bits;
      store_rows(hv, Hw, L::HLD, member_slice(a.h, NF), F, c0, ra, N, lane);  // h
      __syncwarp();
      warp_product<NT, FC>(f, Hw, L::HLD, W2hi, W2lo, L::HLD, lane);
    }
    float rstd2[2];
    residual_norm(f, member_slice(a.bf2, E), a.eps, t, rstd2, [&](int h, int c) {
      return *reinterpret_cast<const float2*>(Xw + (g + 8 * h) * L::XLD + c);  // y1
    });

    // ---- LN2 backward: dr2 = rstd2 (g g2 - mean(g g2) - xhat2 mean(g g2 xhat2))
    const float* cg = member_slice(a.g, NE);
    const float* g2 = member_slice(a.g2, E);
    auto cot = [&](int h, int c) {
      const int64_t row = ra + 8 * h;
      return row < N ? ldg2(cg + row * E + c) : make_float2(0.f, 0.f);
    };
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 gm = ldg2(g2 + c);
      const float2 ga = cot(0, c), gb = cot(1, c);
      s1[0] += ga.x * gm.x + ga.y * gm.y;
      s1[1] += gb.x * gm.x + gb.y * gm.y;
      s2[0] += ga.x * gm.x * f[j][0] + ga.y * gm.y * f[j][1];
      s2[1] += gb.x * gm.x * f[j][2] + gb.y * gm.y * f[j][3];
      add_column_sums(LNw + 2 * E, c,  // dg2 = sum g xhat2
                      make_float2(ga.x * f[j][0] + gb.x * f[j][2],
                                  ga.y * f[j][1] + gb.y * f[j][3]), lane);
      add_column_sums(LNw + 3 * E, c, make_float2(ga.x + gb.x, ga.y + gb.y), lane);  // db2
    }
    float m1[2], m2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m1[h] = quad_sum(s1[h]) / E;
      m2[h] = quad_sum(s2[h]) / E;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 gm = ldg2(g2 + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 cv = cot(h, c);
        f[j][2 * h] = rstd2[h] * (cv.x * gm.x - m1[h] - f[j][2 * h] * m2[h]);
        f[j][2 * h + 1] = rstd2[h] * (cv.y * gm.y - m1[h] - f[j][2 * h + 1] * m2[h]);
      }
    }
    __syncwarp();  // every lane has read its y1 residual
    store_rows(f, Xw, L::XLD, member_slice(a.dr2, NE), E, 0, ra, N, lane);  // dr2
    __syncwarp();

    // ---- FFN backward, chunk by chunk: dh, and dy1 = dr2 + dh . Wf1 in f -----
#pragma unroll 1
    for (int c0 = 0, ci = 0; c0 < F; c0 += FC, ++ci) {
      __syncthreads();  // every warp is done with the staged weights and its dh rows
      stage_split<THREADS>(V2hi, V2lo, LD2, member_slice(a.wf2, E * F) + c0, F, E, FC);
      stage_split<THREADS>(V1hi, V1lo, LD1, member_slice(a.wf1, F * E) + (int64_t)c0 * E,
                           E, FC, E);
      __syncthreads();
      float dv[HT][4];
#pragma unroll
      for (int j = 0; j < HT; ++j) dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
      warp_product_kn<HT, E>(dv, Xw, L::XLD, V2hi, V2lo, LD2, lane);
      const uint32_t bits = Mw[ci * 32 + lane];
#pragma unroll
      for (int j = 0; j < HT; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (!((bits >> (4 * j + q)) & 1u)) dv[j][q] = 0.f;
        }
      }
      store_rows(dv, Hw, L::HLD, member_slice(a.dh, NF), F, c0, ra, N, lane);  // dh
      __syncwarp();
      warp_product_kn<NT, FC>(f, Hw, L::HLD, V1hi, V1lo, LD1, lane);
    }

    // ---- LN1 backward: dr1, written as dx --------------------------------------
    const float* g1b = member_slice(a.g1, E);
    s1[0] = s1[1] = s2[0] = s2[1] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 gm = ldg2(g1b + c);
      float xh[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) xh[q] = XHw[(4 * j + q) * 32 + lane];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d0 = f[j][2 * h] * gm.x, d1 = f[j][2 * h + 1] * gm.y;
        s1[h] += d0 + d1;
        s2[h] += d0 * xh[2 * h] + d1 * xh[2 * h + 1];
      }
      add_column_sums(LNw, c,  // dg1 = sum dy1 xhat1
                      make_float2(f[j][0] * xh[0] + f[j][2] * xh[2],
                                  f[j][1] * xh[1] + f[j][3] * xh[3]), lane);
      add_column_sums(LNw + E, c, make_float2(f[j][0] + f[j][2], f[j][1] + f[j][3]), lane);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m1[h] = quad_sum(s1[h]) / E;
      m2[h] = quad_sum(s2[h]) / E;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 gm = ldg2(g1b + c);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float xh = XHw[(4 * j + q) * 32 + lane];
        f[j][q] = rstd1[q >> 1] * (f[j][q] * ((q & 1) ? gm.y : gm.x) - m1[q >> 1] - xh * m2[q >> 1]);
      }
    }
    __syncwarp();  // every lane has read its dr2 fragments
    store_rows(f, Xw, L::XLD, member_slice(a.dx, NE), E, 0, ra, N, lane);  // dr1 = dx

    // ---- datt = dr1 . Wu ----------------------------------------------------
    __syncthreads();  // every warp is done with the staged chunk; Xw holds dr1
    stage_split<THREADS>(Ws, Ws + L::WU, LD1, member_slice(a.wu, E * E), E, E, E);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NT; ++j) f[j][0] = f[j][1] = f[j][2] = f[j][3] = 0.f;
    warp_product_kn<NT, E>(f, Xw, L::XLD, Ws, Ws + L::WU, LD1, lane);
    store_rows(f, nullptr, 0, member_slice(a.datt, NE), E, 0, ra, N, lane);
  }

  // the block's partial of (dg1, db1) and (dg2, db2): the warps' rows in order
  __syncthreads();
  for (int i = threadIdx.x; i < 4 * E; i += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += LNs[w * 4 * E + i];
    const int half = i / (2 * E);
    member_slice(a.ln_partial, (int64_t)4 * a.blocks * E)[
        ((int64_t)half * a.blocks + blockIdx.x) * 2 * E + i - half * 2 * E] = s;
  }
}

// partial[split] = (D^T X over the split's row tiles, colsum(D)): D (N, O) and
// X (N, C) row-major; the partial is (O, C) row-major, then O column sums.
// Member m = blockIdx.z: D, X and the partials are (M, ...) stacked.
// A block of wm x wn warps owns the output rows o0 .. o0 + 32 wm and columns
// c0 .. c0 + 32 wn; warp (wi, wj) = (w % wm, w / wm) its 32 x 32 piece.
__global__ void __launch_bounds__(32 * MAX_WARPS) fused_ffn_bwd_mma_wgrad(
    const float* __restrict__ D, const float* __restrict__ X, float* __restrict__ partial,
    int N, int O, int C, int wm, int wn, int per_split) {
  extern __shared__ __align__(16) uint32_t wsm[];
  const int BO = 32 * wm, BC = 32 * wn;
  const int ldd = BO + PAD_KN, ldx = BC + PAD_KN;
  uint32_t* Dhi = wsm;
  uint32_t* Dlo = Dhi + WROWS * ldd;
  uint32_t* Xhi = Dlo + WROWS * ldd;
  uint32_t* Xlo = Xhi + WROWS * ldx;
  const int nthreads = blockDim.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wi = warp % wm, wj = warp / wm;
  const int tiles_c = C / BC;
  const int o0 = (blockIdx.x / tiles_c) * BO, c0 = (blockIdx.x % tiles_c) * BC;
  const bool bias = c0 == 0;  // this block also sums D's columns o0 ..
  const int64_t m = blockIdx.z;  // the member
  D += m * N * O;
  X += m * N * C;
  partial += m * gridDim.y * ((int64_t)O * C + O);
  const int row_tiles = (N + WROWS - 1) / WROWS;
  const int t_begin = blockIdx.y * per_split;
  const int t_end = min(t_begin + per_split, row_tiles);
  const int d4 = BO / 4, x4 = BC / 4;  // float4 a staged row
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  float4 cs = make_float4(0.f, 0.f, 0.f, 0.f);  // the thread's 4 columns of colsum(D)

#pragma unroll 1
  for (int tt = t_begin; tt < t_end; ++tt) {
    const int64_t r0 = (int64_t)tt * WROWS;
    __syncthreads();  // every warp is done with the previous rows
    // nthreads is a multiple of d4: a thread stages the same 4 columns of D
    for (int idx = threadIdx.x; idx < WROWS * d4; idx += nthreads) {
      const int r = idx / d4;
      const int c = (idx - r * d4) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < N) v = __ldg(reinterpret_cast<const float4*>(D + (r0 + r) * O + o0 + c));
      cs.x += v.x;
      cs.y += v.y;
      cs.z += v.z;
      cs.w += v.w;
      uint4 h, l;
      split_tf32(v.x, h.x, l.x);
      split_tf32(v.y, h.y, l.y);
      split_tf32(v.z, h.z, l.z);
      split_tf32(v.w, h.w, l.w);
      *reinterpret_cast<uint4*>(Dhi + r * ldd + c) = h;
      *reinterpret_cast<uint4*>(Dlo + r * ldd + c) = l;
    }
    for (int idx = threadIdx.x; idx < WROWS * x4; idx += nthreads) {
      const int r = idx / x4;
      const int c = (idx - r * x4) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < N) v = __ldg(reinterpret_cast<const float4*>(X + (r0 + r) * C + c0 + c));
      uint4 h, l;
      split_tf32(v.x, h.x, l.x);
      split_tf32(v.y, h.y, l.y);
      split_tf32(v.z, h.z, l.z);
      split_tf32(v.w, h.w, l.w);
      *reinterpret_cast<uint4*>(Xhi + r * ldx + c) = h;
      *reinterpret_cast<uint4*>(Xlo + r * ldx + c) = l;
    }
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < WROWS; k0 += 8) {
      FragA fa[2];
      load_a_kn(fa[0], Dhi, Dlo, ldd, 32 * wi, k0, lane);
      load_a_kn(fa[1], Dhi, Dlo, ldd, 32 * wi + 16, k0, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB fb;
        load_b_kn(fb, Xhi, Xlo, ldx, 32 * wj + 8 * j, k0, lane);
        mma_3xtf32(acc[0][j], fa[0], fb);
        mma_3xtf32(acc[1][j], fa[1], fb);
      }
    }
  }

  float* part = partial + (int64_t)blockIdx.y * ((int64_t)O * C + O);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int o = o0 + 32 * wi + 16 * i + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 32 * wj + 8 * j + 2 * t;
      st2(part + (int64_t)o * C + c, acc[i][j][0], acc[i][j][1]);
      st2(part + (int64_t)(o + 8) * C + c, acc[i][j][2], acc[i][j][3]);
    }
  }
  if (bias) {  // the threads of one column group in thread order
    __syncthreads();  // every warp is done with the staged rows
    float4* css = reinterpret_cast<float4*>(wsm);
    css[threadIdx.x] = cs;
    __syncthreads();
    const float* csf = reinterpret_cast<const float*>(wsm);
    for (int i = threadIdx.x; i < BO; i += nthreads) {
      float s = 0.f;
      for (int th = i / 4; th < nthreads; th += d4) s += csf[th * 4 + (i & 3)];
      part[(int64_t)O * C + o0 + i] = s;
    }
  }
}

// The largest divisor of n that is at most cap.
int divisor_at_most(int n, int cap) {
  for (int d = cap < n ? cap : n; d > 1; --d) {
    if (n % d == 0) return d;
  }
  return 1;
}

// grads[0 .. O C + O) = (D^T X, colsum(D)) over N rows: the weight-gradient
// kernel on (output tiles, splits, members), then the reduce over the splits;
// member m's gradients start at grads + m * grads_stride.
cudaError_t weight_gradient(const float* D, const float* X, float* partial, int M, int N, int O,
                            int C, int splits, float* grads, int64_t grads_stride,
                            cudaStream_t stream) {
  const int wm = divisor_at_most(O / 32, 8);
  const int wn = divisor_at_most(C / 32, MAX_WARPS / wm);
  const int smem = 4 * 2 * WROWS * (32 * wm + PAD_KN + 32 * wn + PAD_KN);
  cudaError_t err = cudaFuncSetAttribute(fused_ffn_bwd_mma_wgrad,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int row_tiles = (N + WROWS - 1) / WROWS;
  const int per_split = (row_tiles + splits - 1) / splits;
  const dim3 grid((O / (32 * wm)) * (C / (32 * wn)), splits, M);
  fused_ffn_bwd_mma_wgrad<<<grid, 32 * wm * wn, smem, stream>>>(D, X, partial, N, O, C, wm, wn,
                                                                 per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return partials::reduce(partial, splits, O * C + O, grads, stream, M,
                          (int64_t)splits * (O * C + O), grads_stride);
}

template <int E>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = RowLayout<E>::bytes(a.F);
  cudaError_t err = cudaFuncSetAttribute(fused_ffn_bwd_mma_rows<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  fused_ffn_bwd_mma_rows<E><<<dim3(a.blocks, a.M), THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // grads: dwu (E, E), dbu, dg1, db1 (E each), dwf1 (F, E), dbf1 (F), dwf2
  // (E, F), dbf2, dg2, db2 (E each)
  const int F = a.F, N = a.N, M = a.M;
  const int64_t P = E * E + 2 * E * F + 6 * E + F;  // a member's row of grads
  float* gwu = a.grads;
  float* gg1 = gwu + E * E + E;
  float* gwf1 = gg1 + 2 * E;
  float* gwf2 = gwf1 + F * E + F;
  float* gg2 = gwf2 + E * F + E;
  const float* ln = a.ln_partial;
  const int64_t ln_stride = (int64_t)2 * a.blocks * 2 * E;  // a member's (2, blocks, 2E)
  if ((err = partials::reduce(ln, a.blocks, 2 * E, gg1, stream, M, ln_stride, P)) !=
      cudaSuccess) {
    return err;
  }
  if ((err = partials::reduce(ln + (int64_t)a.blocks * 2 * E, a.blocks, 2 * E, gg2, stream, M,
                              ln_stride, P)) != cudaSuccess) {
    return err;
  }
  if ((err = weight_gradient(a.dr2, a.h, a.w_partial, M, N, E, F, a.splits, gwf2, P,
                             stream)) != cudaSuccess) {
    return err;
  }
  if ((err = weight_gradient(a.dh, a.y1, a.w_partial, M, N, F, E, a.splits, gwf1, P,
                             stream)) != cudaSuccess) {
    return err;
  }
  return weight_gradient(a.dx, a.att, a.w_partial, M, N, E, E, a.splits, gwu, P, stream);
}

}  // namespace

// float32 throughout, every pointer on 16 bytes: att, x, g, datt, dx
// contiguous (N, E); the ten parameters as in mmsn_fused_ffn_fwd_mma; grads
// float32 (E^2 + 2EF + 6E + F): dwu (E, E), dbu, dg1, db1 (E each), dwf1 (F,
// E), dbf1 (F), dwf2 (E, F), dbf2, dg2, db2 (E each). Scratch, float32: dr2
// and y1 (N, E), h and dh (N, F), ln_partial (2, blocks, 2E), w_partial
// (splits, EF + F). E is 64, 96 or 128; F a multiple of 32; 1 <= blocks <=
// ceil(N / 64) (the row kernel's grid); 1 <= splits <= ceil(N / 32) (the
// weight-gradient kernel's row splits). M >= 1 stacked members: every tensor
// above gets a leading member axis (M, ...), one launch of each kernel for all.
extern "C" int mmsn_fused_ffn_bwd_mma(const void* att, const void* x, const void* wu,
                                      const void* bu, const void* g1, const void* b1,
                                      const void* wf1, const void* bf1, const void* wf2,
                                      const void* bf2, const void* g2, const void* b2,
                                      const void* g, void* datt, void* dx, void* grads,
                                      void* dr2, void* h, void* dh, void* y1, void* ln_partial,
                                      void* w_partial, int M, int N, int E, int F,
                                      int blocks, int splits, float eps, void* stream) {
  const void* ptrs[22] = {att,  x,  wu,    bu,  g1, b1, wf1, bf1, wf2,        bf2,      g2,
                          b2,   g,  datt,  dx,  grads, dr2, h, dh, y1, ln_partial, w_partial};
  for (const void* q : ptrs) {
    if (reinterpret_cast<uintptr_t>(q) % 16) return cudaErrorInvalidValue;
  }
  // M is grid.y and grid.z: at most 65535
  if (M < 1 || M > 65535 || N < 1 || F < FC || F % FC || blocks < 1 ||
      blocks > (N + ROWS - 1) / ROWS || splits < 1 || splits > (N + WROWS - 1) / WROWS) {
    return cudaErrorInvalidValue;
  }
  Args a;
  a.att = static_cast<const float*>(att);
  a.x = static_cast<const float*>(x);
  a.wu = static_cast<const float*>(wu);
  a.bu = static_cast<const float*>(bu);
  a.g1 = static_cast<const float*>(g1);
  a.b1 = static_cast<const float*>(b1);
  a.wf1 = static_cast<const float*>(wf1);
  a.bf1 = static_cast<const float*>(bf1);
  a.wf2 = static_cast<const float*>(wf2);
  a.bf2 = static_cast<const float*>(bf2);
  a.g2 = static_cast<const float*>(g2);
  a.b2 = static_cast<const float*>(b2);
  a.g = static_cast<const float*>(g);
  a.datt = static_cast<float*>(datt);
  a.dx = static_cast<float*>(dx);
  a.grads = static_cast<float*>(grads);
  a.dr2 = static_cast<float*>(dr2);
  a.h = static_cast<float*>(h);
  a.dh = static_cast<float*>(dh);
  a.y1 = static_cast<float*>(y1);
  a.ln_partial = static_cast<float*>(ln_partial);
  a.w_partial = static_cast<float*>(w_partial);
  a.M = M;
  a.N = N;
  a.F = F;
  a.blocks = blocks;
  a.splits = splits;
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (E) {
    case 64: return launch<64>(a, st);
    case 96: return launch<96>(a, st);
    case 128: return launch<128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}
