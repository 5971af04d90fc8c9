// Masked multi-head attention backward for Hopper (sm_90a) on the tensor cores,
// bf16 at head dims 8, 16, 32 and 64.
//
// Replaces the Pallas TPU kernel multimodal_supernovae_tpu/ops/pallas_attention.py
// (_bwd_kernel, reached through _flash_bwd) on the bf16 main path, and computes
// what csrc/flash_attention_bwd.cu (the CUDA-core kernels, which keep the
// other head dims and rows off 16 bytes) computes, the gradient of
// ops/attention.py:dense_attention.
// With c = emb**-0.25, qs = bf16(q * c), ks = bf16(k * c), P rebuilt from the
// forward's per-row (max, sum) residual:
//   dP = g . v^T                          (float32 accumulation)
//   D  = g . out at S = 8 and 16,         (one float32 per row, see below)
//        c0 + rowsum(P o (dP - c0)) at S = 32 and 64, c0 = dP at key 0
//   dS = P o (dP - D), zeroed at masked keys, rounded to bf16
//   dq = dS . ks * c,  dk = dS^T . qs * c,  dv = bf16(P)^T . g
// In a fully masked row P is uniform over its T keys, so dv at a masked key is
// not zero while dk and dq are. bf16(P) and bf16(dS) are the operand types of
// mma.sync, so every product is one bf16 mma with float32 accumulation.
// D = g . out takes one dot product a row. The CUDA-core kernel takes
// rowsum(P o dP) instead, as the reference does: in float32, where a row's
// values are nearly equal across its keys, the output's rounding in g . out
// shows in dq (csrc/flash_attention_bwd.cu). At S = 8 and 16 the bf16 limits
// hold it, and a second walk of the keys would add a third to the backward's
// device time at the training shapes (PERF.md section 6, ROADMAP.md section
// 3b). At S = 32 and 64 the user path is the ViT image
// tower (4 and 2 heads), whose 36 keys are near-uniform, exactly where dP - D
// cancels and the bf16 rounding of out in g . out would come through whole;
// there the dq kernel walks the keys twice, as the CUDA-core and 3xTF32
// kernels do: D = c0 + rowsum(P o (dP - c0)) in float32 first, then dS and
// dq. Either forward's stats and output feed this backward.
//
// What bounds it on this card: as in the forward, not the products: per
// (query, key) pair each of the two kernels rebuilds P with one exponential
// and some six float32 operations, against 3 * S and 4 * S multiply-adds that
// now run on the tensor cores. It runs at 3-4x the exponentials' floor at
// the training shapes; what it waits on beyond them is open, as for the
// forward (PERF.md). The design:
//   * dq kernel, grid (B*H, ceil(T/64)), 4 warps of 16 query rows. A warp keeps
//     qs and g as A fragments; K/V tiles of 64 keys stream through shared
//     memory (cp.async, double-buffered, K rounded to bf16(k * c) in place by
//     the thread that copied it). Per 16 keys: S = qs . ks^T and dP = g . v^T
//     (mma, B fragments by ldmatrix), P and dS on the C fragments, then
//     dq += bf16(dS) . ks (dS's C fragments as the A fragment, ks by
//     ldmatrix.trans). It also writes D for its rows to a float32 scratch.
//     At S = 32 and 64 (S / 16 chained m16n8k16 a head-dim product) a first
//     walk over the key tiles sums D; shared tiles grow to 20 and 37 KB.
//   * dk/dv kernel, launched after it on the same stream, grid (B*H,
//     ceil(T/64)), 4 warps of 16 key rows keeping ks and v as A fragments;
//     query tiles of 64 (qs, g, and each row's max, 1/sum and D) stream through
//     shared memory. Per 16 queries: S^T = ks . qs^T, dP^T = v . g^T, then
//     dv += bf16(P^T) . g and dk += bf16(dS^T) . qs.
// At S = 64 the dk/dv kernel keeps ks and v (16 registers each), dk and dv
// (32 each) and a step's q and g fragments (16 each) in registers; with a
// tile's four 16-row steps unrolled ptxas spilled 16 bytes at 255
// registers, so at S = 64 the kernels unroll two steps at a time (245
// registers, no spill, the same time: probe_flash_tc_steps.py). A warp whose
// 16 rows all lie past T (the fourth of the ViT's T = 36) keeps to the copies
// and barriers and skips the compute, and at S = 32 and 64 a tile's 16-row
// steps whose rows all lie past T (the last of the ViT's four) are skipped:
// they add zeros. At S = 8 and 16 the exit test raised the dq kernel from 72
// to 96 registers (7 to 5 blocks an SM) and cost 7% at T = 1024 for nothing
// at T = 200 (probe_flash_tc_steps.py --parent), so those walk every step.
// Each kernel owns its outputs: no atomics, deterministic. D is read from the
// scratch, once per row, instead of being recomputed in every dk/dv block.
// Where no key is masked (a dq key tile all valid, by the block's vote at the
// barrier; a dk/dv warp's 16 keys all valid) the selects go and P takes one
// FMA and one exponential off -(max + log2 sum).
//
// Plain C interface, loaded with ctypes (kernels/build.py): the entry launches
// both kernels on the given stream and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape, head dim or alignment it does not take.
// It does not synchronise and allocates nothing (the D scratch is the
// caller's).

#include "flash_attention_mma.cuh"

#include <cmath>

namespace {

using namespace flash_mma;

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const uint8_t* mask;  // (B, T) bytes or null
  const bf16* out;
  const float2* stats;  // (B*H*T) rows' (max in the log2 domain, sum)
  const bf16* g;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* dsum;          // (B*H*T) scratch: D of each row
  int H, T_len;
  float scale;
  Strides sin, sout, sg, sgrad;  // q/k/v; out; g; dq, dk and dv
};

// One TILE-key tile of the dq kernel for one warp's 16 query rows. DENSE: every
// key of the tile is valid (the block's vote at the barrier): no select, and
// P = exp2(s * log2e - (m + log2 sum)) in one FMA and one exponential. A row
// with a valid key has a moderate max m, so m + log2 sum keeps its precision;
// the general path keeps m and 1/sum apart for fully masked rows, whose m is
// -1e7 * log2e.
template <int S, bool DENSE>
__device__ __forceinline__ void dq_tile(float (&acc)[S / 8][4], const uint32_t (&qa)[S / 4],
                                        const uint32_t (&ga)[S / 4], const float (&m)[2],
                                        const float (&inv_l)[2], const float (&nlse)[2],
                                        const float (&D)[2], const bf16* ks, const bf16* vs,
                                        const uint8_t* kind, int n_steps, int lane) {
  const int t = lane & 3;
#pragma unroll (S == 64 ? 2 : TILE / 16)  // registers at S = 64 (see the note at the top)
  for (int kk = 0; kk < TILE / 16; ++kk) {  // 16 keys a step
    if (S >= 32 && kk >= n_steps) break;  // the rest of the tile lies past T
    uint32_t kf[2][S / 8], vf[2][S / 8];
    ldsm_rows<S>(kf, ks, 16 * kk, lane);
    ldsm_rows<S>(vf, vs, 16 * kk, lane);
    float s[2][4], dp[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mma_head<S>(s[i], qa, kf[i]);
      mma_head<S>(dp[i], ga, vf[i]);
    }
    // dS is zero at a masked key and there is none past T
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        if constexpr (DENSE) {
          s[i][e] = exp2_approx(fmaf(s[i][e], LOG2E, nlse[r])) * (dp[i][e] - D[r]);
        } else {
          const float p = exp2_approx(s[i][e] * LOG2E - m[r]) * inv_l[r];
          const bool valid = kind[16 * kk + 8 * i + 2 * t + (e & 1)] == 0;
          s[i][e] = valid ? p * (dp[i][e] - D[r]) : 0.f;
        }
      }
    }
    uint32_t dsa[4];
    c_to_a(dsa, s[0], s[1]);
    uint32_t kt[S / 8][2];
    ldsm_cols<S>(kt, ks, 16 * kk, lane);
#pragma unroll
    for (int n = 0; n < S / 8; ++n) mma_k16(acc[n], dsa, kt[n][0], kt[n][1]);
  }
}

// One TILE-key tile of the dq kernel's first walk at S = 32 (SUM_D): this
// lane's share of rowsum(P o (dP - c0)) for its two rows, over the tile's
// valid keys. Selects, not products, drop the rest (P may be infinite there:
// a fully masked row's max is -1e7 * log2e).
template <int S>
__device__ __forceinline__ void dsum_tile(float (&dd)[2], const uint32_t (&qa)[S / 4],
                                          const uint32_t (&ga)[S / 4], const float (&m)[2],
                                          const float (&inv_l)[2], const float (&c0)[2],
                                          const bf16* ks, const bf16* vs, const uint8_t* kind,
                                          int n_steps, int lane) {
  const int t = lane & 3;
#pragma unroll (S == 64 ? 2 : TILE / 16)  // registers at S = 64 (see the note at the top)
  for (int kk = 0; kk < TILE / 16; ++kk) {  // 16 keys a step
    if (S >= 32 && kk >= n_steps) break;  // the rest of the tile lies past T
    uint32_t kf[2][S / 8], vf[2][S / 8];
    ldsm_rows<S>(kf, ks, 16 * kk, lane);
    ldsm_rows<S>(vf, vs, 16 * kk, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float s[4], dp[4];
      mma_head<S>(s, qa, kf[i]);
      mma_head<S>(dp, ga, vf[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = exp2_approx(s[e] * LOG2E - m[r]) * inv_l[r];
        const bool valid = kind[16 * kk + 8 * i + 2 * t + (e & 1)] == 0;
        dd[r] += valid ? p * (dp[e] - c0[r]) : 0.f;
      }
    }
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS) flash_attention_bwd_dq_mma_kernel(const BwdArgs a) {
  // D summed over the keys (a first walk) rather than g . out: see the note
  // at the top
  constexpr bool SUM_D = S >= 32;
  using L = Layout<S>;
  __shared__ __align__(16) bf16 ks[2][TILE * L::RS];
  __shared__ __align__(16) bf16 vs[2][TILE * L::RS];
  __shared__ uint8_t kind[2][TILE];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g_ = lane >> 2, t = lane & 3;
  const int T_len = a.T_len;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int64_t base = a.sin.at(b, h, 0);
  const bf16* kb = a.k + base;
  const bf16* vb = a.v + base;
  const bf16* gb = a.g + a.sg.at(b, h, 0);
  const bf16* ob = a.out + a.sout.at(b, h, 0);
  const uint8_t* mrow = a.mask != nullptr ? a.mask + (int64_t)b * T_len : nullptr;
  const int row0 = blockIdx.y * ROWS + warp * 16;

  uint32_t qa[S / 4], ga[S / 4];
  load_a<S>(qa, a.q + base, a.sin.t, row0, T_len, a.scale, true, lane);
  load_a<S>(ga, gb, a.sg.t, row0, T_len, 1.f, false, lane);

  // Rows past T get m = 0, 1/sum = 0, -(m + log2 sum) = -inf and D = 0: P and
  // dS vanish there. D starts as g . out, or under SUM_D as c0 = g . v0, the
  // dP of key 0, to which the first walk adds rowsum(P o (dP - c0)).
  float m[2], inv_l[2], nlse[2], D[2];
  float dd[2] = {0.f, 0.f};  // SUM_D: this lane's share of rowsum(P o (dP - c0))
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g_ + 8 * r;
    const bf16* dref = SUM_D ? vb : ob + row * a.sout.t;
    float part = 0.f;
    if (row < T_len) {
#pragma unroll
      for (int kh = 0; kh < S / 8; ++kh) {
        const float2 gv = unpack_bf16(ga[2 * kh + r]);
        const float2 ov =
            unpack_bf16(*reinterpret_cast<const uint32_t*>(dref + 8 * kh + 2 * t));
        part = fmaf(gv.x, ov.x, part);
        part = fmaf(gv.y, ov.y, part);
      }
    }
    D[r] = quad_sum(part);
    m[r] = 0.f;
    inv_l[r] = 0.f;
    nlse[r] = -INFINITY;
    if (row < T_len) {
      const float2 st = a.stats[(int64_t)bh * T_len + row];
      m[r] = st.x;
      inv_l[r] = 1.f / st.y;
      nlse[r] = -(st.x + log2f(st.y));
      if (!SUM_D && t == 0) a.dsum[(int64_t)bh * T_len + row] = D[r];
    }
  }

  float acc[S / 8][4];
#pragma unroll
  for (int n = 0; n < S / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // the key tiles once, or under SUM_D twice: D first, then dS and dq
  const int n_tiles = (T_len + TILE - 1) / TILE;
  const int n_iter = SUM_D ? 2 * n_tiles : n_tiles;
  issue_tile<S>(ks[0], vs[0], kb, vb, a.sin.t, a.sin.t, 0, T_len, tid);
  cp_async_commit();
  uint8_t my_kind = tid < TILE ? key_kind(mrow, tid, T_len) : 0;
  if (tid < TILE) kind[0][tid] = my_kind;

  for (int it = 0; it < n_iter; ++it) {
    const int buf = it & 1;
    const bool more = it + 1 < n_iter;
    const int next_key = ((it + 1) % n_tiles) * TILE + tid;
    uint8_t next_byte = 1;
    if (more) {
      issue_tile<S>(ks[buf ^ 1], vs[buf ^ 1], kb, vb, a.sin.t, a.sin.t,
                    ((it + 1) % n_tiles) * TILE, T_len, tid);
      if (tid < TILE) next_byte = mask_byte(mrow, next_key, T_len);
    }
    cp_async_commit();
    cp_async_wait<1>();
    scale_own_chunks<S>(ks[buf], a.scale, tid);
    // 16-key steps of this tile with a key below T; the rest add nothing
    const int n_steps = (T_len - (it % n_tiles) * TILE + 15) / 16;
    if (SUM_D && it < n_tiles) {
      __syncthreads();
      if (row0 < T_len)
        dsum_tile<S>(dd, qa, ga, m, inv_l, D, ks[buf], vs[buf], kind[buf], n_steps, lane);
    } else {
      if (SUM_D && it == n_tiles) {  // D of each row, from its four lanes' shares
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          D[r] += quad_sum(dd[r]);
          const int row = row0 + g_ + 8 * r;
          if (t == 0 && row < T_len) a.dsum[(int64_t)bh * T_len + row] = D[r];
        }
      }
      const bool dense = __syncthreads_and(my_kind == 0);
      if (row0 >= T_len) {  // no row of this warp: copies and barriers only
      } else if (dense) {
        dq_tile<S, true>(acc, qa, ga, m, inv_l, nlse, D, ks[buf], vs[buf], kind[buf], n_steps,
                         lane);
      } else {
        dq_tile<S, false>(acc, qa, ga, m, inv_l, nlse, D, ks[buf], vs[buf], kind[buf], n_steps,
                          lane);
      }
    }
    my_kind = tid < TILE ? kind_of(next_byte, next_key, T_len) : 0;
    if (more && tid < TILE) kind[buf ^ 1][tid] = my_kind;
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g_ + 8 * r;
    if (row >= T_len) continue;
    bf16* o = a.dq + a.sgrad.at(b, h, row);
#pragma unroll
    for (int n = 0; n < S / 8; ++n) {
      *reinterpret_cast<uint32_t*>(o + 8 * n + 2 * t) =
          pack_bf16(acc[n][2 * r] * a.scale, acc[n][2 * r + 1] * a.scale);
    }
  }
}

// One TILE-query tile of the dk/dv kernel for one warp's 16 key rows. DENSE:
// the warp's 16 keys are all valid, so no query row of this sample is fully
// masked and P = exp2(s * log2e - (m + log2 sum)) in one FMA (see dq_tile).
template <int S, bool DENSE>
__device__ __forceinline__ void dkdv_tile(float (&dk)[S / 8][4], float (&dv)[S / 8][4],
                                          const uint32_t (&ka)[S / 4],
                                          const uint32_t (&va)[S / 4], const bool (&valid)[2],
                                          const bf16* qs, const bf16* gs, const float4* qrow,
                                          int n_steps, int lane) {
  const int t = lane & 3;
#pragma unroll (S == 64 ? 2 : TILE / 16)  // registers at S = 64 (see the note at the top)
  for (int kk = 0; kk < TILE / 16; ++kk) {  // 16 queries a step
    if (S >= 32 && kk >= n_steps) break;  // the rest of the tile lies past T
    uint32_t qf[2][S / 8], gf[2][S / 8];
    ldsm_rows<S>(qf, qs, 16 * kk, lane);
    ldsm_rows<S>(gf, gs, 16 * kk, lane);
    float p[2][4], ds[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mma_head<S>(p[i], ka, qf[i]);   // S^T: keys x queries
      mma_head<S>(ds[i], va, gf[i]);  // dP^T
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 qr = qrow[16 * kk + 8 * i + 2 * t + c];  // (m, 1/sum, D, -(m + log2 sum))
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          if constexpr (DENSE) {
            const float pe = exp2_approx(fmaf(p[i][e], LOG2E, qr.w));
            p[i][e] = pe;
            ds[i][e] = pe * (ds[i][e] - qr.z);
          } else {
            const float x = valid[r] ? p[i][e] * LOG2E : MASK_FILL_LOG2;
            const float pe = exp2_approx(x - qr.x) * qr.y;
            p[i][e] = pe;
            ds[i][e] = valid[r] ? pe * (ds[i][e] - qr.z) : 0.f;
          }
        }
      }
    }
    uint32_t pa[4], dsa[4];
    c_to_a(pa, p[0], p[1]);
    c_to_a(dsa, ds[0], ds[1]);
    uint32_t gt[S / 8][2], qt[S / 8][2];
    ldsm_cols<S>(gt, gs, 16 * kk, lane);
    ldsm_cols<S>(qt, qs, 16 * kk, lane);
#pragma unroll
    for (int n = 0; n < S / 8; ++n) {
      mma_k16(dv[n], pa, gt[n][0], gt[n][1]);
      mma_k16(dk[n], dsa, qt[n][0], qt[n][1]);
    }
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS) flash_attention_bwd_dkdv_mma_kernel(const BwdArgs a) {
  using L = Layout<S>;
  __shared__ __align__(16) bf16 qs[2][TILE * L::RS];
  __shared__ __align__(16) bf16 gs[2][TILE * L::RS];
  __shared__ float4 qrow[2][TILE];  // each query's (max, 1/sum, D, -(max + log2 sum))

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g_ = lane >> 2, t = lane & 3;
  const int T_len = a.T_len;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int64_t base = a.sin.at(b, h, 0);
  const bf16* qb = a.q + base;
  const bf16* gb = a.g + a.sg.at(b, h, 0);
  const uint8_t* mrow = a.mask != nullptr ? a.mask + (int64_t)b * T_len : nullptr;
  const int row0 = blockIdx.y * ROWS + warp * 16;

  uint32_t ka[S / 4], va[S / 4];
  load_a<S>(ka, a.k + base, a.sin.t, row0, T_len, a.scale, true, lane);
  load_a<S>(va, a.v + base, a.sin.t, row0, T_len, 1.f, false, lane);
  // A masked key (or one past T) keeps the fill score: P there is 0 unless the
  // whole query row is masked, where it is 1/T like every other key of the row.
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) valid[r] = key_kind(mrow, row0 + g_ + 8 * r, T_len) == 0;
  const bool dense = __all_sync(0xffffffffu, valid[0] && valid[1]);

  float dk[S / 8][4], dv[S / 8][4];
#pragma unroll
  for (int n = 0; n < S / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  // Queries past T: max 0, 1/sum 0, D 0, -(max + log2 sum) -inf (qs and g are
  // zero there): P = dS = 0.
  // The residual's (max, sum) and D are read at the top of an iteration and
  // turned into the row's numbers after its compute (see mask_byte).
  auto query_row = [&](int row, float2 st, float d) {
    if (row >= T_len) return make_float4(0.f, 0.f, 0.f, -INFINITY);
    return make_float4(st.x, 1.f / st.y, d, -(st.x + log2f(st.y)));
  };
  auto read_row = [&](int row, float2& st, float& d) {
    if (row < T_len) {
      st = a.stats[(int64_t)bh * T_len + row];
      d = a.dsum[(int64_t)bh * T_len + row];
    }
  };

  const int n_tiles = (T_len + TILE - 1) / TILE;
  issue_tile<S>(qs[0], gs[0], qb, gb, a.sin.t, a.sg.t, 0, T_len, tid);
  cp_async_commit();
  if (tid < TILE) {
    float2 st = make_float2(0.f, 1.f);
    float d = 0.f;
    read_row(tid, st, d);
    qrow[0][tid] = query_row(tid, st, d);
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const bool more = it + 1 < n_tiles;
    const int next_query = (it + 1) * TILE + tid;
    float2 next_st = make_float2(0.f, 1.f);
    float next_d = 0.f;
    if (more) {
      issue_tile<S>(qs[buf ^ 1], gs[buf ^ 1], qb, gb, a.sin.t, a.sg.t, (it + 1) * TILE, T_len,
                    tid);
      if (tid < TILE) read_row(next_query, next_st, next_d);
    }
    cp_async_commit();
    cp_async_wait<1>();
    scale_own_chunks<S>(qs[buf], a.scale, tid);
    // 16-query steps of this tile with a query below T; the rest add nothing
    const int n_steps = (T_len - it * TILE + 15) / 16;
    __syncthreads();
    if (row0 >= T_len) {  // no key row of this warp: copies and barriers only
    } else if (dense) {
      dkdv_tile<S, true>(dk, dv, ka, va, valid, qs[buf], gs[buf], qrow[buf], n_steps, lane);
    } else {
      dkdv_tile<S, false>(dk, dv, ka, va, valid, qs[buf], gs[buf], qrow[buf], n_steps, lane);
    }
    if (more && tid < TILE) qrow[buf ^ 1][tid] = query_row(next_query, next_st, next_d);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g_ + 8 * r;
    if (row >= T_len) continue;
    const int64_t off = a.sgrad.at(b, h, row);
#pragma unroll
    for (int n = 0; n < S / 8; ++n) {
      *reinterpret_cast<uint32_t*>(a.dk + off + 8 * n + 2 * t) =
          pack_bf16(dk[n][2 * r] * a.scale, dk[n][2 * r + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(a.dv + off + 8 * n + 2 * t) =
          pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <int S>
cudaError_t launch(const BwdArgs& a, int B, cudaStream_t stream) {
  const dim3 grid(B * a.H, (a.T_len + ROWS - 1) / ROWS);
  flash_attention_bwd_dq_mma_kernel<S><<<grid, THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dkdv_mma_kernel<S><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, k, v share the (b, h, t) strides (sib, sih, sit); out, g and the
// gradients have their own; the S dim is contiguous in all, and q, k, v and g
// rows start on 16 bytes (data pointers and strides in multiples of 8
// elements). dq, dk and dv share (sdb, sdh, sdt). mask is (B, T) bytes,
// contiguous, or null for "all valid"; stats is the forward's (B*H*T, 2)
// float32 residual; dsum is a (B*H*T) float32 scratch.
extern "C" int mmsn_flash_attention_bwd_mma(
    const void* q, const void* k, const void* v, const void* mask, const void* out,
    const void* stats, const void* g, void* dq, void* dk, void* dv, void* dsum, int B, int H,
    int T_len, int S, float scale, int64_t sib, int64_t sih, int64_t sit, int64_t sob,
    int64_t soh, int64_t sot, int64_t sgb, int64_t sgh, int64_t sgt, int64_t sdb,
    int64_t sdh, int64_t sdt, void* stream) {
  if (B < 1 || H < 1 || T_len < 1 || (int64_t)B * H > 0x7fffffff ||
      (T_len + ROWS - 1) / ROWS > 65535 || stats == nullptr || dsum == nullptr)
    return cudaErrorInvalidValue;
  if (!rows_aligned(q, sib, sih, sit) || !rows_aligned(k, sib, sih, sit) ||
      !rows_aligned(v, sib, sih, sit) || !rows_aligned(g, sgb, sgh, sgt) ||
      sob % 2 || soh % 2 || sot % 2 || reinterpret_cast<uintptr_t>(out) % 4 ||
      sdb % 2 || sdh % 2 || sdt % 2 || reinterpret_cast<uintptr_t>(dq) % 4 ||
      reinterpret_cast<uintptr_t>(dk) % 4 || reinterpret_cast<uintptr_t>(dv) % 4)
    return cudaErrorInvalidValue;
  BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = static_cast<const bf16*>(out);
  a.stats = static_cast<const float2*>(stats);
  a.g = static_cast<const bf16*>(g);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.dsum = static_cast<float*>(dsum);
  a.H = H;
  a.T_len = T_len;
  a.scale = scale;
  a.sin = Strides{sib, sih, sit};
  a.sout = Strides{sob, soh, sot};
  a.sg = Strides{sgb, sgh, sgt};
  a.sgrad = Strides{sdb, sdh, sdt};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 8:
      return launch<8>(a, B, st);
    case 16:
      return launch<16>(a, B, st);
    case 32:
      return launch<32>(a, B, st);
    case 64:
      return launch<64>(a, B, st);
    default:
      return cudaErrorInvalidValue;
  }
}
