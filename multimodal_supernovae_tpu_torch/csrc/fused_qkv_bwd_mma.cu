// The whole SelfAttention backward on Hopper's tensor cores (sm_90a,
// mma.sync), bf16 at (E, head dim) = (32, 8), (32, 16) and (64, 8): a kernel
// that recomputes the forward and takes every gradient of a sample, and the
// reduce kernel of csrc/reduce_partials.cuh.
//
// Replaces the Pallas TPU kernel multimodal_supernovae_tpu/ops/
// qkv_attention.py (_bwd_kernel, reached through the custom_vjp's _qkv_bwd)
// on the bf16 path, and computes what csrc/fused_qkv_bwd.cu (the CUDA-core
// kernel, which keeps float32) computes,
// ops/qkv_attention.py:fused_qkv_attention_bwd_plain of this package, at the
// JAX kernel's rounding points:
//   qkv = bf16(x . bf16(Wqkv)^T); P = softmax(s) in float32 (masked keys SET
//   to -1e7), rebuilt from the row max and sum over all keys;
//   att = bf16(bf16(P) . v); datt = bf16(g . bf16(Wu));
//   dWu = sum g^T att, dbu = sum g (float32);
//   dP = datt_h . v^T; D = rowsum(P o dP) over all keys, as the reference does;
//   dS = bf16(P o (dP - D)), 0 at masked keys;
//   dq = bf16(dS . k), dk = bf16(dS^T . q), dv = bf16(bf16(P)^T . datt_h);
//   dx = bf16(dqkv . bf16(Wqkv)) over the 3E contraction in float32;
//   dWqkv = sum dqkv^T x (float32).
// Every product is one bf16 mma.sync with float32 accumulation (m16n8k8 for
// the head-dim contractions at head dim 8, m16n8k16 for the rest), with P and
// dS passed from C to A fragments in registers.
//
// Layout: a fixed grid of `blocks` blocks of 16 warps walks the samples b,
// b + blocks, ...; warp w owns rows 16w .. 16w + 15 of a sample
// (csrc/fused_qkv_mma.cuh). Per sample:
//   1. x (cp.async), bf16(Wqkv), bf16(Wu) and the key kinds to shared memory;
//      each warp projects its rows into shared q, k, v buffers (Tp, E).
//   2. Per head, phase A, the warp's rows as queries: datt_h = g . Wu[:, h]
//      (g's rows read from device memory) to a shared (Tp, S) buffer, then
//      four passes over the keys: the row max; the row sum; att (written over
//      x, which the projection no longer needs) and D; dS and dq. Each row's
//      (max, 1/sum, D) goes to shared memory. A barrier.
//   3. Phase B, the warp's rows as keys: one pass over the queries, rebuilding
//      P^T from k . q^T and each query's (max, 1/sum, D): dv += bf16(P^T) .
//      datt_h and dk += dS^T . q; dk and dv overwrite the warp's own k and v
//      columns of head h (no other warp reads them again). A barrier; then dq
//      overwrites the warp's own q columns of head h.
//   4. dx of the warp's rows from its own dq, dk, dv rows and bf16(Wqkv).
//      Then g replaces the staged weights and dWu += g^T att, dbu += sum g;
//      x replaces att and dWqkv += dqkv^T x. Those two are block-wide
//      products over the sample's rows (qkv_mma::sum_at_b); each warp
//      accumulates its output tiles in registers over all of the block's
//      samples.
// At the end each block writes its float32 partial of (dWqkv, dWu, dbu) and
// reduce_partials sums the partials in block order: deterministic, no
// atomics, as in the CUDA-core kernel.
//
// What bounds it on this card: at the light-curve shape (256, 200, 64, 8) the
// products are 12 GFLOP with the recompute (12 us at 989 TFLOP/s) and the
// bytes 20 MB (6 us); the 328M exponentials (three a (query, key) pair in
// phase A, one in phase B) take 78 us on the MUFU pipes, and the masks and
// softmax arithmetic around them are the larger share. One block of 16 warps
// an SM (193 KB of shared memory at T = 256, E = 64), two barriers a head.
//
// Stacked members (torch.func.vmap over an ensemble, ops/qkv_attention.py)
// are grid.y of both kernels: member m walks its own B samples (x, mask, g, dx
// (M, B, ...) stacked) with the block count a call for m alone takes, reads
// its own Wqkv and Wu ((M, ...) stacked), writes its own (blocks, P) partials,
// and the reduce sums them in block order into its own row of grads: bitwise
// that call's result.
//
// Shared memory: 2 (E + 8) (4 Tp + max(4 E, Tp)) + 2 Tp SRS + 16 Tp + Tp
// bytes, Tp = ceil16(T), SRS = 8 at head dim 8 and 24 at 16.
//
// Plain C interface, loaded with ctypes (kernels/build.py): the entry returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a shape
// or alignment it does not take. It launches on the given stream, does not
// synchronise and allocates nothing (the partials are the caller's).

#include "fused_qkv_mma.cuh"
#include "reduce_partials.cuh"

#include <cmath>

namespace {

using namespace qkv_mma;

struct BwdArgs {  // each with a leading member axis (M, ...) when stacked
  const bf16* x;        // (B, T, E)
  const uint8_t* mask;  // (B, T) bytes or null
  const float* wqkv;    // (3E, E)
  const float* wu;      // (E, E)
  const bf16* g;        // (B, T, E)
  bf16* dx;             // (B, T, E)
  float* partial;       // (blocks, 4 E^2 + E)
  int B, T_len;
};

// The kernel's arguments for member m (its blocks are gridDim.x).
template <int E>
__device__ __forceinline__ BwdArgs member_args(BwdArgs a, int64_t m) {
  const int64_t rows = m * a.B * a.T_len;
  a.x += rows * E;
  a.g += rows * E;
  a.dx += rows * E;
  if (a.mask != nullptr) a.mask += rows;
  a.wqkv += m * 3 * E * E;
  a.wu += m * E * E;
  a.partial += m * gridDim.x * (4 * E * E + E);
  return a;
}

template <int E, int S>
struct Smem {
  static constexpr int RS = Dims<E>::RS;
  static constexpr int SRS = flash_mma::Layout<S>::RS;  // row stride of datt_h
  static int bytes(int Tp) {
    const int wg = 4 * E > Tp ? 4 * E : Tp;
    return 16 * Tp + 2 * RS * (4 * Tp + wg) + 2 * Tp * SRS + Tp;
  }
};

// A fragment of 16 x S from the float32 C tiles of S / 8 column tiles, rounded.
template <int S>
__device__ __forceinline__ void c_to_a_head(uint32_t (&a)[S / 4], const float (&c)[S / 8][4]) {
#pragma unroll
  for (int n = 0; n < S / 8; ++n) {
    a[2 * n] = pack_bf16(c[n][0], c[n][1]);
    a[2 * n + 1] = pack_bf16(c[n][2], c[n][3]);
  }
}

// Phase A of head h for the warp's query rows row0 .. row0 + 15 (see the
// file's note). dq is left in registers for the caller to store after the
// barrier that ends phase B.
template <int E, int S>
__device__ __forceinline__ void phase_a(float (&dq)[S / 8][4], const BwdArgs& a, int64_t b,
                                        int h, int row0, const bf16* Q, const bf16* K,
                                        const bf16* V, const bf16* WU, bf16* ATT, bf16* DH,
                                        float4* ST, const uint8_t* kind, int lane) {
  constexpr int RS = Smem<E, S>::RS, SRS = Smem<E, S>::SRS;
  const int g_ = lane >> 2, t = lane & 3;
  const int T_len = a.T_len, n_kc = pad16(T_len) / 16;
  const bf16* kh = K + h * S;
  const bf16* vh = V + h * S;

  // datt_h = bf16(g . bf16(Wu)[:, hS .. hS + S]) of the warp's rows
  float dc[S / 8][4];
#pragma unroll
  for (int n = 0; n < S / 8; ++n) dc[n][0] = dc[n][1] = dc[n][2] = dc[n][3] = 0.f;
  const bf16* gb = a.g + b * T_len * E;
#pragma unroll
  for (int kk = 0; kk < E / 16; ++kk) {
    uint32_t ga[4];
#pragma unroll
    for (int kh2 = 0; kh2 < 2; ++kh2) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + g_ + 8 * r;
        ga[2 * kh2 + r] = row < T_len ? *reinterpret_cast<const uint32_t*>(
                                            gb + row * E + 16 * kk + 8 * kh2 + 2 * t)
                                      : 0u;
      }
    }
    uint32_t wb[S / 8][2];
    ldsm_cols<S>(wb, WU + h * S, 16 * kk, lane, RS);
#pragma unroll
    for (int n = 0; n < S / 8; ++n) mma_k16(dc[n], ga, wb[n][0], wb[n][1]);
  }
  uint32_t da[S / 4], q[S / 4];
  c_to_a_head<S>(da, dc);
#pragma unroll
  for (int n = 0; n < S / 8; ++n) store_c(DH + row0 * SRS, SRS, 8 * n, dc[n], lane);
  ldsm_a_head<S>(q, Q + row0 * RS + h * S, RS, lane);

  // pass 1: the row max over all keys (log2 domain, after the mask)
  float m[2] = {-INFINITY, -INFINITY};
  for (int kc = 0; kc < n_kc; ++kc) {
    float s[2][4];
    head_product<S>(s, q, kh, RS, kc, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        m[e >> 1] = fmaxf(m[e >> 1], masked_log2(s[i][e], kind[16 * kc + 8 * i + 2 * t + (e & 1)]));
      }
    }
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  // pass 2: the row sum
  float l[2] = {0.f, 0.f};
  for (int kc = 0; kc < n_kc; ++kc) {
    float s[2][4];
    head_product<S>(s, q, kh, RS, kc, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        l[e >> 1] += exp2_approx(
            masked_log2(s[i][e], kind[16 * kc + 8 * i + 2 * t + (e & 1)]) - m[e >> 1]);
      }
    }
  }
  const float inv_l[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
  // pass 3: att = bf16(bf16(P) . v) and D = rowsum(P o dP)
  float o[S / 8][4], D[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < S / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int kc = 0; kc < n_kc; ++kc) {
    float s[2][4], dp[2][4];
    head_product<S>(s, q, kh, RS, kc, lane);
    head_product<S>(dp, da, vh, RS, kc, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(masked_log2(s[i][e], kind[16 * kc + 8 * i + 2 * t + (e & 1)]) -
                                    m[e >> 1]) * inv_l[e >> 1];
        s[i][e] = p;
        D[e >> 1] = fmaf(p, dp[i][e], D[e >> 1]);
      }
    }
    uint32_t pa[4], vf[S / 8][2];
    c_to_a(pa, s[0], s[1]);
    ldsm_cols<S>(vf, vh, 16 * kc, lane, RS);
#pragma unroll
    for (int n = 0; n < S / 8; ++n) mma_k16(o[n], pa, vf[n][0], vf[n][1]);
  }
  D[0] = quad_sum(D[0]);
  D[1] = quad_sum(D[1]);
#pragma unroll
  for (int n = 0; n < S / 8; ++n) store_c(ATT + row0 * RS, RS, h * S + 8 * n, o[n], lane);
  if (t == 0) {  // rows past T: (0, 0, 0), so phase B sees P = 0 there
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g_ + 8 * r;
      ST[row] = row < T_len ? make_float4(m[r], inv_l[r], D[r], 0.f) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  // pass 4: dS = P o (dP - D), zero at masked keys; dq += bf16(dS) . k
#pragma unroll
  for (int n = 0; n < S / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  for (int kc = 0; kc < n_kc; ++kc) {
    float s[2][4], dp[2][4];
    head_product<S>(s, q, kh, RS, kc, lane);
    head_product<S>(dp, da, vh, RS, kc, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint8_t kd = kind[16 * kc + 8 * i + 2 * t + (e & 1)];
        const float p = exp2_approx(masked_log2(s[i][e], kd) - m[e >> 1]) * inv_l[e >> 1];
        s[i][e] = kd == 0 ? p * (dp[i][e] - D[e >> 1]) : 0.f;
      }
    }
    uint32_t dsa[4], kt[S / 8][2];
    c_to_a(dsa, s[0], s[1]);
    ldsm_cols<S>(kt, kh, 16 * kc, lane, RS);
#pragma unroll
    for (int n = 0; n < S / 8; ++n) mma_k16(dq[n], dsa, kt[n][0], kt[n][1]);
  }
}

// Phase B of head h for the warp's key rows row0 .. row0 + 15: dk and dv
// overwrite the warp's own k and v columns of head h.
template <int E, int S>
__device__ __forceinline__ void phase_b(int T_len, int h, int row0, const bf16* Q, bf16* K,
                                        bf16* V, const bf16* DH, const float4* ST,
                                        const uint8_t* kind, int lane) {
  constexpr int RS = Smem<E, S>::RS, SRS = Smem<E, S>::SRS;
  const int g_ = lane >> 2, t = lane & 3;
  const int n_qc = pad16(T_len) / 16;
  const bf16* qh = Q + h * S;
  uint32_t ka[S / 4], va[S / 4];
  ldsm_a_head<S>(ka, K + row0 * RS + h * S, RS, lane);
  ldsm_a_head<S>(va, V + row0 * RS + h * S, RS, lane);
  const uint8_t kd[2] = {kind[row0 + g_], kind[row0 + g_ + 8]};
  float dk[S / 8][4], dv[S / 8][4];
#pragma unroll
  for (int n = 0; n < S / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }
  for (int qc = 0; qc < n_qc; ++qc) {  // 16 queries a step
    float p[2][4], ds[2][4];
    head_product<S>(p, ka, qh, RS, qc, lane);   // S^T: keys x queries
    head_product<S>(ds, va, DH, SRS, qc, lane);  // dP^T
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 st = ST[16 * qc + 8 * i + 2 * t + c];  // (max, 1/sum, D) of the query
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          const float pe = exp2_approx(masked_log2(p[i][e], kd[r]) - st.x) * st.y;
          p[i][e] = pe;
          ds[i][e] = kd[r] == 0 ? pe * (ds[i][e] - st.z) : 0.f;
        }
      }
    }
    uint32_t pa[4], dsa[4], gt[S / 8][2], qt[S / 8][2];
    c_to_a(pa, p[0], p[1]);
    c_to_a(dsa, ds[0], ds[1]);
    ldsm_cols<S>(gt, DH, 16 * qc, lane, SRS);
    ldsm_cols<S>(qt, qh, 16 * qc, lane, RS);
#pragma unroll
    for (int n = 0; n < S / 8; ++n) {
      mma_k16(dv[n], pa, gt[n][0], gt[n][1]);
      mma_k16(dk[n], dsa, qt[n][0], qt[n][1]);
    }
  }
#pragma unroll
  for (int n = 0; n < S / 8; ++n) {
    store_c(K + row0 * RS, RS, h * S + 8 * n, dk[n], lane);
    store_c(V + row0 * RS, RS, h * S + 8 * n, dv[n], lane);
  }
}

template <int E, int S>
__global__ void __launch_bounds__(THREADS, 1) fused_qkv_bwd_mma_kernel(const BwdArgs args) {
  using L = Smem<E, S>;
  const BwdArgs a = member_args<E>(args, blockIdx.y);
  constexpr int RS = L::RS, SRS = L::SRS, H = E / S;
  constexpr int UQ = (3 * (E / 16) * (E / 16) + WARPS - 1) / WARPS;  // dWqkv tiles a warp
  constexpr int UU = ((E / 16) * (E / 16) + WARPS - 1) / WARPS;      // dWu tiles a warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int T_len = a.T_len, Tp = pad16(T_len);
  float4* ST = reinterpret_cast<float4*>(smem);  // (Tp): a query's (max, 1/sum, D)
  bf16* XA = reinterpret_cast<bf16*>(ST + Tp);   // (Tp, E): x, then att
  bf16* Q = XA + Tp * RS;                        // (Tp, E): q -> dq
  bf16* K = Q + Tp * RS;                         // (Tp, E): k -> dk
  bf16* V = K + Tp * RS;                         // (Tp, E): v -> dv
  bf16* WG = V + Tp * RS;                        // bf16(Wqkv), bf16(Wu); then g
  bf16* DH = WG + (4 * E > Tp ? 4 * E : Tp) * RS;  // (Tp, S): datt_h
  uint8_t* kind = reinterpret_cast<uint8_t*>(DH + Tp * SRS);
  bf16* WU = WG + 3 * E * RS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g_ = lane >> 2, t = lane & 3;
  const int row0 = 16 * warp;
  const bool active = row0 < Tp;

  float acc_q[UQ][2][4], acc_u[UU][2][4], dbu = 0.f;
#pragma unroll
  for (int u = 0; u < UQ; ++u) {
#pragma unroll
    for (int i = 0; i < 2; ++i) acc_q[u][i][0] = acc_q[u][i][1] = acc_q[u][i][2] = acc_q[u][i][3] = 0.f;
  }
#pragma unroll
  for (int u = 0; u < UU; ++u) {
#pragma unroll
    for (int i = 0; i < 2; ++i) acc_u[u][i][0] = acc_u[u][i][1] = acc_u[u][i][2] = acc_u[u][i][3] = 0.f;
  }

  for (int64_t b = blockIdx.x; b < a.B; b += gridDim.x) {
    const bf16* xb = a.x + b * T_len * E;
    // 1. x, the weights and the key kinds; the projection
    load_rows_async<E>(XA, xb, T_len, tid);
    cp_async_commit();
    stage_weight<E>(WG, a.wqkv, 3 * E, tid);
    stage_weight<E>(WU, a.wu, E, tid);
    write_kinds(kind, a.mask != nullptr ? a.mask + b * T_len : nullptr, T_len, tid);
    cp_async_wait<0>();
    __syncthreads();
    if (active) {
      uint32_t xa[E / 16][4];
      load_row_tile<E>(xa, XA + row0 * RS, lane);
#pragma unroll
      for (int n0 = 0; n0 < 3 * E; n0 += 16) {
        float c[2][4];
        tile_x_wt<E>(c, xa, WG + n0 * RS, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int col = n0 + 8 * i;
          store_c((col < E ? Q : col < 2 * E ? K : V) + row0 * RS, RS, col % E, c[i], lane);
        }
      }
    }
    __syncthreads();  // q, k, v of every row; x is free for att

    // 2-3. per head: phase A (queries), phase B (keys)
#pragma unroll 1
    for (int h = 0; h < H; ++h) {
      float dq[S / 8][4];
      if (active) phase_a<E, S>(dq, a, b, h, row0, Q, K, V, WU, XA, DH, ST, kind, lane);
      __syncthreads();  // datt_h and the rows' (max, 1/sum, D)
      if (active) phase_b<E, S>(T_len, h, row0, Q, K, V, DH, ST, kind, lane);
      __syncthreads();  // phase B's reads of q, datt_h and the row numbers
      if (active) {
#pragma unroll
        for (int n = 0; n < S / 8; ++n) store_c(Q + row0 * RS, RS, h * S + 8 * n, dq[n], lane);
      }
    }

    // 4. dx = bf16(dqkv . bf16(Wqkv)) of the warp's rows (its own dq, dk, dv)
    if (active) {
      __syncwarp();
      bf16* dxb = a.dx + b * T_len * E;
      const bf16* parts[3] = {Q, K, V};
#pragma unroll
      for (int n0 = 0; n0 < E; n0 += 16) {
        float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          uint32_t da[E / 16][4];
          load_row_tile<E>(da, parts[p] + row0 * RS, lane);
          tile_x_w<E / 16>(c, da, WG + p * E * RS + n0, RS, lane);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = row0 + g_ + 8 * r;
            if (row < T_len) {
              *reinterpret_cast<uint32_t*>(dxb + row * E + n0 + 8 * i + 2 * t) =
                  pack_bf16(c[i][2 * r], c[i][2 * r + 1]);
            }
          }
        }
      }
    }
    __syncthreads();  // the staged weights are free
    // dWu += g^T att, dbu += sum g
    load_rows_async<E>(WG, a.g + b * T_len * E, T_len, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    {
      const bf16* parts[1] = {WG};
      sum_at_b<E, 1, UU>(acc_u, parts, XA, Tp, warp, lane);
    }
    if (tid < E) {
      for (int r = 0; r < T_len; ++r) dbu += __bfloat162float(WG[r * RS + tid]);
    }
    __syncthreads();  // att and g are consumed
    // dWqkv += dqkv^T x
    load_rows_async<E>(XA, xb, T_len, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    {
      const bf16* parts[3] = {Q, K, V};
      sum_at_b<E, 3, UQ>(acc_q, parts, XA, Tp, warp, lane);
    }
    __syncthreads();  // before the next sample's loads
  }

  float* part = a.partial + (int64_t)blockIdx.x * (4 * E * E + E);
  store_sum<E, 3, UQ>(part, acc_q, warp, lane);
  store_sum<E, 1, UU>(part + 3 * E * E, acc_u, warp, lane);
  if (tid < E) part[4 * E * E + tid] = dbu;
}

template <int E, int S>
cudaError_t launch(const BwdArgs& a, float* grads, int M, int blocks, cudaStream_t stream) {
  const int smem = Smem<E, S>::bytes(pad16(a.T_len));
  cudaError_t err = cudaFuncSetAttribute(fused_qkv_bwd_mma_kernel<E, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_qkv_bwd_mma_kernel<E, S><<<dim3(blocks, M), THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int P = 4 * E * E + E;
  return partials::reduce(a.partial, blocks, P, grads, stream, M, (int64_t)blocks * P, P);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

// x, g, dx: bf16 (B, T, E), contiguous, 16-byte aligned. mask: bool (B, T),
// one byte each, or null. wqkv float32 (3E, E) and wu float32 (E, E), 16-byte
// aligned. partial is float32 (blocks, P) scratch, P = 4 E^2 + E, 8-byte
// aligned, with 1 <= blocks <= B; grads is float32 (P): dwqkv (3E, E), dwu
// (E, E), dbu (E). 1 <= T <= 256; (E, E / H) one of (32, 8), (32, 16),
// (64, 8). M >= 1 stacked members: x, g, dx (M, B, T, E), mask (M, B, T) or
// null, wqkv (M, 3E, E), wu (M, E, E), partial (M, blocks, P) and grads (M, P),
// one launch of each kernel for all of them (a member's offsets keep the
// alignment).
extern "C" int mmsn_fused_qkv_bwd_mma(const void* x, const void* mask, const void* wqkv,
                                      const void* wu, const void* g, void* dx, void* partial,
                                      void* grads, int M, int B, int T, int E, int H,
                                      int blocks, void* stream) {
  // M is grid.y: at most 65535
  if (M < 1 || M > 65535 || B < 1 || T < 1 || T > MAX_T || H < 1 || E % H || blocks < 1 ||
      blocks > B || !aligned(x, 16) || !aligned(g, 16) || !aligned(dx, 16) ||
      !aligned(wqkv, 16) || !aligned(wu, 16) || !aligned(partial, 8)) {
    return cudaErrorInvalidValue;
  }
  BwdArgs a;
  a.x = static_cast<const bf16*>(x);
  a.mask = static_cast<const uint8_t*>(mask);
  a.wqkv = static_cast<const float*>(wqkv);
  a.wu = static_cast<const float*>(wu);
  a.g = static_cast<const bf16*>(g);
  a.dx = static_cast<bf16*>(dx);
  a.partial = static_cast<float*>(partial);
  a.B = B;
  a.T_len = T;
  float* out = static_cast<float*>(grads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = E / H;
  if (E == 64 && S == 8) return launch<64, 8>(a, out, M, blocks, st);
  if (E == 32 && S == 8) return launch<32, 8>(a, out, M, blocks, st);
  if (E == 32 && S == 16) return launch<32, 16>(a, out, M, blocks, st);
  return cudaErrorInvalidValue;
}
