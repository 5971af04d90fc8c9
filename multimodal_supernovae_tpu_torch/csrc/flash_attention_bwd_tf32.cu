// Masked multi-head attention backward for Hopper (sm_90a) on the tensor cores,
// float32 at head dims 8, 16, 32 and 64, every product in 3xTF32.
//
// Replaces the Pallas TPU kernel multimodal_supernovae_tpu/ops/pallas_attention.py
// (_bwd_kernel, reached through _flash_bwd) on the float32 path every shipped
// configuration trains on, and computes what csrc/flash_attention_bwd.cu (the
// CUDA-core kernels, which keep the other head dims and rows off 16 bytes)
// computes
// for float32, the gradient of ops/attention.py:dense_attention. With c =
// emb**-0.25, qs = q * c, ks = k * c, P rebuilt from the forward's per-row
// (max in the log2 domain, sum) residual:
//   dP = g . v^T
//   D  = c0 + rowsum(P o (dP - c0)),  c0 = dP at key 0
//   dS = P o (dP - D), zeroed at masked keys
//   dq = dS . ks * c,  dk = dS^T . qs * c,  dv = P^T . g
// In a fully masked row P is uniform over its T keys, so dv at a masked key is
// not zero while dk and dq are. All seven products (S and dP in each kernel,
// dq, dk, dv) are three TF32 mma.sync each (csrc/tf32x3.cuh), about float32
// accuracy.
//
// D is the CUDA-core route's sum, not the bf16 tensor-core route's g . out:
// where a row's values are nearly equal across its keys (deep encoder
// layers), dP - D cancels and any error of D comes through whole, and g . out
// put float32 dq 4-10x farther from float64 than the plain version
// (csrc/flash_attention_bwd.cu). The shift by c0 is taken inside the product:
// dP - c0 = g . (v - v0), v0 = v at key 0, with v - v0 formed in float32
// before the split. Its 3xTF32 error is then relative to |v - v0|, small
// exactly where the rows are nearly equal, instead of to |v|. The kernels
// never form dP itself: dS = P o ((dP - c0) - (D - c0)). The dq kernel
// writes D - c0 to the float32 scratch for the dk/dv kernel.
//
// What bounds it on this card: per (query, key) pair 7 * S multiply-adds,
// three TF32 passes of them on the tensor cores (0.091 ms at the trimodal
// spectral shape (32, 2, 1024, 16) at 495 TFLOP/s), beside three
// exponentials (ex2.approx: the dq kernel's two passes, the dk/dv kernel's
// one) and the float32 elementwise work of P, dS and their TF32 splits. The
// design follows the bf16 tensor-core kernels (csrc/flash_attention_bwd_mma.cu),
// two kernels that each own their outputs: no atomics, deterministic. Tiles
// of 64 rows stream by cp.async, double-buffered, and are split once a block
// (csrc/flash_attention_tf32.cuh): into TF32 hi and lo row tiles where a
// product reads the tile's rows as its columns (by ldmatrix), into a
// transposed tile of (hi, lo) pairs where a product sums over them (16 bytes
// a B fragment). Each TF32 pass has its own accumulator, and each 8-row step
// of a sum over keys or queries is added on the CUDA cores (mma_rows).
//   * dq kernel, grid (B*H, ceil(T/64)), 4 warps of 16 query rows. A warp
//     keeps qs * log2(e) and g as split A fragments; K tiles (k * c; row and
//     transposed) and V tiles (v - v0; row) of 64 keys stream through 40 KB
//     of shared memory at S = 16. It walks the keys twice: first D, then per
//     8 keys S = qs . ks^T and dP - c0 = g . (v - v0)^T, P and dS on the C
//     fragments, dq += dS . ks (the C fragment as the A fragment with the key
//     index permuted). At S = 32 the tiles take 72 KB.
//   * dk/dv kernel, launched after it on the same stream, grid (B*H,
//     ceil(T/64)), 4 warps of 16 key rows keeping ks * log2(e) and v - v0 as
//     split A fragments; query tiles of 64 (qs and g, row and transposed, and
//     each row's max, 1/sum and D - c0) stream through 49 KB of shared
//     memory at S = 16, 91 KB at S = 32 (the ViT image tower's head dim;
//     launch_dyn raises the block's limit above 48 KB). Per 8 queries: S^T = ks . qs^T and (dP - c0)^T = (v -
//     v0) . g^T, then dv += P^T . g and dk += dS^T . qs, the query index
//     permuted.
//   * A warp whose 16 rows all lie past T (the fourth of the ViT's T = 36)
//     keeps to the copies, splits and barriers and skips the compute, and at
//     S = 32 and 64 a tile's 8-row steps whose rows all lie past T (three of
//     eight at T = 36) are skipped: they add zeros. At S = 8 and 16 the exit
//     test cost 5% at T = 1024 (its unrolled steps no longer one block of
//     code) for 6-7% at T = 200 and 220 (probe_flash_tc_steps.py --parent),
//     so those walk every step, as before.
// Head dim 64 (the ViT image tower at 2 heads) is the hard case: registers.
// A lane's split A fragments of one side are S registers (64), an
// accumulator S / 2 (32). The dq kernel keeps its two sides and dq (160) in
// registers, and at S = 64 reads v0 for v - v0 from device memory at each
// split instead of holding its chunks (S / 2 registers there). The dk/dv
// kernel would hold two sides and two accumulators (192) beside a step's
// temporaries, past the 255 a thread may hold; so at S = 64 each warp
// writes its v - v0 fragments, split, once into its own 16-row hi and lo
// tiles of shared memory (8.7 KB a warp) and reads them back by ldmatrix at
// each use (mma_head_smem), keeping ks, dk and dv in registers. ks is the
// side both products of a step need first; v - v0 feeds only dP. Both
// kernels at S = 64 walk a tile's 8-row steps one at a time (no unrolling):
// unrolled two or eight at a time, ptxas spilled 20-168 bytes at 255
// registers and the backward ran 5-10% slower (probe_flash_tc_steps.py).
// Shared memory at S = 64: 141 KB (dq) and 214 KB (dk/dv) of the 227 a
// block may take, one block an SM; at T <= 64 (one tile, the ViT) the raw
// tiles are single (raw_buffers): 107 KB (two dq blocks an SM) and 179 KB,
// and the dq kernel copies and splits its one key tile once for both walks
// (1.3x faster at (256, 2, 36, 64) than copying it again). Rolled, the dk/dv
// kernel holds 255 registers with no spill; the dq kernel spills 4 bytes,
// one value, which its second walk's reuse of the tile costs and is kept.
//
// Plain C interface, loaded with ctypes (kernels/build.py): the entry launches
// both kernels on the given stream and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape, head dim or alignment it does not take.
// It does not synchronise and allocates nothing (the D scratch is the
// caller's). It does not read the forward's output.

#include "flash_attention_tf32.cuh"

#include <cmath>

namespace {

using namespace flash_tf32;

struct BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const uint8_t* mask;  // (B, T) bytes or null
  const float2* stats;  // (B*H*T) rows' (max in the log2 domain, sum)
  const float* g;
  float* dq;
  float* dk;
  float* dv;
  float* dsum;          // (B*H*T) scratch: D - c0 of each row
  int H, T_len;
  float scale;
  Strides sin, sg, sgrad;  // q/k/v; g; dq, dk and dv
};

// One 64-key tile of the dq kernel for one warp's 16 query rows. PASS 0 adds
// P o (dP - c0) of the valid keys to this lane's share of D - c0 (dd); PASS 1
// takes dS = P o ((dP - c0) - (D - c0)) and adds dS . ks to acc. A masked key
// adds nothing: P is 0 there unless the whole row is masked, whose dS is 0
// anyway; a key past T is not valid either. Selects, not products, drop the
// keys that are not valid (P may be infinite there: a fully masked row's max
// is -1e7 * log2e).
template <int S, int PASS>
__device__ __forceinline__ void dq_tile(float (&acc)[S / 8][4], float (&dd)[2],
                                        const FragA (&qa)[S / 8], const FragA (&ga)[S / 8],
                                        const float (&m)[2], const float (&inv_l)[2],
                                        const uint32_t* khi, const uint32_t* klo,
                                        const uint32_t* ktr, const uint32_t* vhi,
                                        const uint32_t* vlo, const uint8_t* kind,
                                        int n_steps, int lane) {
  const int t = lane & 3;
#pragma unroll (S == 64 ? 1 : TILE / 8)  // registers at S = 64 (see the note at the top)
  for (int j = 0; j < TILE / 8; ++j) {  // 8 keys a step
    if (S >= 32 && j >= n_steps) break;  // the rest of the tile lies past T
    float s[4], dp[4];
    mma_head<S>(s, qa, khi, klo, 8 * j, lane);
    mma_head<S>(dp, ga, vhi, vlo, 8 * j, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const bool valid = kind[8 * j + 2 * t + (e & 1)] == 0;
      const float p = exp2_approx(s[e] - m[r]) * inv_l[r];
      if constexpr (PASS == 0) {
        dd[r] += valid ? p * dp[e] : 0.f;
      } else {
        s[e] = valid ? p * (dp[e] - dd[r]) : 0.f;
      }
    }
    if constexpr (PASS == 1) mma_rows<S>(acc, s, ktr, 8 * j, lane);
  }
}

// Dynamic shared memory of the dq kernel, in words: K's lo tile, K's
// transposed tile, V's lo tile, the key kinds x 2, then for each of nbuf =
// raw_buffers(T) buffers K's row tile (k * c; the cp.async target, TF32 hi
// after the split) and V's (v - v0). The buffers come last, so every offset
// is a constant and one buffer is only a shorter allocation.
template <int S>
int dq_smem_words(int nbuf) {
  return 2 * LayoutF<S>::TS + LayoutF<S>::TT + 2 * TILE / 4 + nbuf * 2 * LayoutF<S>::TS;
}

template <int S>
__global__ void __launch_bounds__(THREADS) flash_attention_bwd_dq_tf32_kernel(const BwdArgs a) {
  using L = LayoutF<S>;
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int BS = 2 * L::TS;  // words from one buffer's raw tiles to the next's
  uint32_t* const ks_lo = smem;
  uint32_t* const ktr = smem + L::TS;
  uint32_t* const vs_lo = ktr + L::TT;
  uint8_t(*kind)[TILE] = reinterpret_cast<uint8_t(*)[TILE]>(vs_lo + L::TS);
  uint32_t* const ks0 = vs_lo + L::TS + 2 * TILE / 4;  // + buf * BS: buffer buf's tiles
  uint32_t* const vs0 = ks0 + L::TS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g_ = lane >> 2, t = lane & 3;
  const int T_len = a.T_len;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int64_t base = a.sin.at(b, h, 0);
  const float* kb = a.k + base;
  const float* vb = a.v + base;
  const uint8_t* mrow = a.mask != nullptr ? a.mask + (int64_t)b * T_len : nullptr;
  const int row0 = blockIdx.y * ROWS + warp * 16;

  FragA qa[S / 8], ga[S / 8];
  {
    float x[S / 8][4];
    load_rows<S>(x, a.q + base, a.sin.t, row0, T_len, lane);
#pragma unroll
    for (int kk = 0; kk < S / 8; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[kk][e] = x[kk][e] * a.scale * LOG2E;
      split_a(qa[kk], x[kk]);
    }
    load_rows<S>(x, a.g + a.sg.at(b, h, 0), a.sg.t, row0, T_len, lane);
#pragma unroll
    for (int kk = 0; kk < S / 8; ++kk) split_a(ga[kk], x[kk]);
  }
  // this thread's chunks of v0 for v - v0, in registers below head dim 64
  float4 v0[S < 64 ? LayoutF<S>::CH : 1];
  if constexpr (S < 64) own_chunks_of_row0<S>(v0, vb, tid);

  // Rows past T get m = 0 and 1/sum = 0: P and dS vanish there (q is 0).
  float m[2], inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g_ + 8 * r;
    m[r] = 0.f;
    inv_l[r] = 0.f;
    if (row < T_len) {
      const float2 st = a.stats[(int64_t)bh * T_len + row];
      m[r] = st.x;
      inv_l[r] = 1.f / st.y;
    }
  }

  float acc[S / 8][4];
#pragma unroll
  for (int n = 0; n < S / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float dd[2] = {0.f, 0.f};  // this lane's share of D - c0, then the row's

  // the key tiles twice: D first, then dS and dq. A single tile (one raw
  // buffer, raw_buffers) is copied and split once, the transposed K with it,
  // and walked twice.
  const int n_tiles = (T_len + TILE - 1) / TILE;
  const int n_iter = 2 * n_tiles;
  issue_rows<S>(ks0, kb, a.sin.t, 0, T_len, tid);
  issue_rows<S>(vs0, vb, a.sin.t, 0, T_len, tid);
  cp_async_commit();
  if (tid < TILE) kind[0][tid] = key_kind(mrow, tid, T_len);

  for (int it = 0; it < n_iter; ++it) {
    const bool reuse = n_tiles == 1 && it == 1;  // the single tile, split in walk one
    const int buf = n_tiles == 1 ? 0 : it & 1;
    const bool more = n_tiles > 1 && it + 1 < n_iter;
    const int next_key = ((it + 1) % n_tiles) * TILE + tid;
    uint8_t next_byte = 1;
    if (more) {
      issue_rows<S>(ks0 + (buf ^ 1) * BS, kb, a.sin.t, ((it + 1) % n_tiles) * TILE, T_len,
                    tid);
      issue_rows<S>(vs0 + (buf ^ 1) * BS, vb, a.sin.t, ((it + 1) % n_tiles) * TILE, T_len,
                    tid);
      if (tid < TILE) next_byte = mask_byte(mrow, next_key, T_len);
    }
    uint32_t* const kt = ks0 + buf * BS;
    uint32_t* const vt = vs0 + buf * BS;
    if (!reuse) {
      cp_async_commit();
      cp_async_wait<1>();
      // the transposed K only for the dq pass (dS . ks)
      split_chunks<S>(kt, ks_lo, it < n_tiles && n_tiles > 1 ? nullptr : ktr, a.scale, tid);
      if constexpr (S < 64) {  // v - v0
        split_chunks<S>(vt, vs_lo, nullptr, 1.f, v0, tid);
      } else {
        split_chunks<S>(vt, vs_lo, nullptr, 1.f, vb, tid);
      }
    }
    // 8-key steps of this tile with a key below T; the rest add nothing
    const int n_steps = (T_len - (it % n_tiles) * TILE + 7) / 8;
    __syncthreads();
    if (row0 >= T_len) {  // no row of this warp: copies, splits and barriers only
    } else if (it < n_tiles) {
      dq_tile<S, 0>(acc, dd, qa, ga, m, inv_l, kt, ks_lo, ktr, vt, vs_lo, kind[buf], n_steps,
                    lane);
    } else {
      if (it == n_tiles) {  // the row's D - c0, from its four lanes' shares
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dd[r] = quad_sum(dd[r]);
          const int row = row0 + g_ + 8 * r;
          if (t == 0 && row < T_len) a.dsum[(int64_t)bh * T_len + row] = dd[r];
        }
      }
      dq_tile<S, 1>(acc, dd, qa, ga, m, inv_l, kt, ks_lo, ktr, vt, vs_lo, kind[buf], n_steps,
                    lane);
    }
    if (more && tid < TILE) kind[buf ^ 1][tid] = kind_of(next_byte, next_key, T_len);
    __syncthreads();
  }

  store_rows<S>(a.dq + a.sgrad.at(b, h, 0), a.sgrad.t, acc, a.scale, row0, T_len, lane);
}

// One 64-query tile of the dk/dv kernel for one warp's 16 key rows. A masked
// key (or one past T) keeps the fill score: P there is 0 unless the whole
// query row is masked, where it is 1/T like every other key of the row (and
// then every key of the sample is masked, so no valid key meets that row).
// VA_SMEM: v - v0 is read from the warp's shared tiles va_hi, va_lo, not va.
template <int S, bool VA_SMEM>
__device__ __forceinline__ void dkdv_tile(float (&dk)[S / 8][4], float (&dv)[S / 8][4],
                                          const FragA (&ka)[S / 8],
                                          const FragA (&va)[VA_SMEM ? 1 : S / 8],
                                          const uint32_t* va_hi, const uint32_t* va_lo,
                                          const bool (&valid)[2], const uint32_t* qhi,
                                          const uint32_t* qlo, const uint32_t* qtr,
                                          const uint32_t* ghi, const uint32_t* glo,
                                          const uint32_t* gtr, const float4* qrow,
                                          int n_steps, int lane) {
  const int t = lane & 3;
#pragma unroll (S == 64 ? 1 : TILE / 8)  // registers at S = 64 (see the note at the top)
  for (int j = 0; j < TILE / 8; ++j) {  // 8 queries a step
    if (S >= 32 && j >= n_steps) break;  // the rest of the tile lies past T
    float p[4], ds[4];
    mma_head<S>(p, ka, qhi, qlo, 8 * j, lane);   // S^T: keys x queries
    if constexpr (VA_SMEM) {
      mma_head_smem<S>(ds, va_hi, va_lo, ghi, glo, 8 * j, lane);  // (dP - c0)^T
    } else {
      mma_head<S>(ds, va, ghi, glo, 8 * j, lane);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float4 qr = qrow[8 * j + 2 * t + (e & 1)];  // (max, 1/sum, D - c0, -)
      const float x = valid[r] ? p[e] : MASK_FILL_LOG2;
      p[e] = exp2_approx(x - qr.x) * qr.y;
      ds[e] = valid[r] ? p[e] * (ds[e] - qr.z) : 0.f;
    }
    mma_rows<S>(dv, p, gtr, 8 * j, lane);
    mma_rows<S>(dk, ds, qtr, 8 * j, lane);
  }
}

// Dynamic shared memory of the dk/dv kernel, in words: q's row tiles (q * c;
// the cp.async target, TF32 hi after the split) x 2, its lo and transposed
// Dynamic shared memory of the dk/dv kernel, in words: q's lo and transposed
// tiles, g's, each query's (max, 1/sum, D - c0, unused), at S = 64 each
// warp's v - v0 hi and lo tiles (16 rows each), then for each of nbuf =
// raw_buffers(T) buffers q's row tile (q * c; the cp.async target, TF32 hi
// after the split) and g's. The buffers come last, so every offset is a
// constant and one buffer is only a shorter allocation.
template <int S>
__host__ __device__ constexpr bool va_smem() {
  return S == 64;
}

template <int S>
__host__ __device__ constexpr int va_words() {
  return va_smem<S>() ? WARPS * 2 * 16 * LayoutF<S>::RS : 0;
}

template <int S>
int dkdv_smem_words(int nbuf) {
  return 2 * LayoutF<S>::TS + 2 * LayoutF<S>::TT + 4 * TILE + va_words<S>() +
         nbuf * 2 * LayoutF<S>::TS;
}

template <int S>
__global__ void __launch_bounds__(THREADS) flash_attention_bwd_dkdv_tf32_kernel(
    const BwdArgs a) {
  using L = LayoutF<S>;
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int BS = 2 * L::TS;  // words from one buffer's raw tiles to the next's
  uint32_t* const qs_lo = smem;
  uint32_t* const qtr = smem + L::TS;
  uint32_t* const gs_lo = qtr + L::TT;
  uint32_t* const gtr = gs_lo + L::TS;
  float4* const qrow = reinterpret_cast<float4*>(gtr + L::TT);
  constexpr bool VA_SMEM = va_smem<S>();
  // + buf * BS: buffer buf's raw tiles
  uint32_t* const qs0 = gtr + L::TT + 4 * TILE + va_words<S>();
  uint32_t* const gs0 = qs0 + L::TS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g_ = lane >> 2;
  const int T_len = a.T_len;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int64_t base = a.sin.at(b, h, 0);
  const float* qb = a.q + base;
  const float* gb = a.g + a.sg.at(b, h, 0);
  const uint8_t* mrow = a.mask != nullptr ? a.mask + (int64_t)b * T_len : nullptr;
  const int row0 = blockIdx.y * ROWS + warp * 16;
  // this warp's v - v0 tiles (VA_SMEM)
  uint32_t* const va_hi = gtr + L::TT + 4 * TILE + warp * 2 * 16 * L::RS;
  uint32_t* const va_lo = va_hi + 16 * L::RS;

  FragA ka[S / 8], va[VA_SMEM ? 1 : S / 8];
  {
    float x[S / 8][4];
    load_rows<S>(x, a.k + base, a.sin.t, row0, T_len, lane);
#pragma unroll
    for (int kk = 0; kk < S / 8; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[kk][e] = x[kk][e] * a.scale * LOG2E;
      split_a(ka[kk], x[kk]);
    }
    // v - v0: every place of the fragment less key 0's value at its column
    // (rows past T too: their keys' dS and P are dropped or zero)
    load_rows<S>(x, a.v + base, a.sin.t, row0, T_len, lane);
#pragma unroll
    for (int kk = 0; kk < S / 8; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[kk][e] -= a.v[base + 8 * kk + (lane & 3) + 4 * (e >> 1)];
      if constexpr (VA_SMEM) {
        split_a(va[0], x[kk]);
        store_a_smem<S>(va_hi, va_lo, va[0], kk, lane);
      } else {
        split_a(va[kk], x[kk]);
      }
    }
    if constexpr (VA_SMEM) __syncwarp();  // the warp's own tiles, read by ldmatrix
  }
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) valid[r] = key_kind(mrow, row0 + g_ + 8 * r, T_len) == 0;

  float dk[S / 8][4], dv[S / 8][4];
#pragma unroll
  for (int n = 0; n < S / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  // Queries past T: max 0, 1/sum 0, D - c0 0 (qs and g are zero there): P =
  // dS = 0. The residual and D - c0 are read at the top of an iteration and
  // turned into the row's numbers after its compute (see mask_byte).
  auto query_row = [&](int row, float2 st, float d) {
    if (row >= T_len) return make_float4(0.f, 0.f, 0.f, 0.f);
    return make_float4(st.x, 1.f / st.y, d, 0.f);
  };
  auto read_row = [&](int row, float2& st, float& d) {
    if (row < T_len) {
      st = a.stats[(int64_t)bh * T_len + row];
      d = a.dsum[(int64_t)bh * T_len + row];
    }
  };
  const int n_tiles = (T_len + TILE - 1) / TILE;
  issue_rows<S>(qs0, qb, a.sin.t, 0, T_len, tid);
  issue_rows<S>(gs0, gb, a.sg.t, 0, T_len, tid);
  cp_async_commit();
  float2 cur_st = make_float2(0.f, 1.f);  // this thread's query of the current tile
  float cur_d = 0.f;
  if (tid < TILE) read_row(tid, cur_st, cur_d);

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const bool more = it + 1 < n_tiles;
    const int next_query = (it + 1) * TILE + tid;
    float2 next_st = make_float2(0.f, 1.f);
    float next_d = 0.f;
    if (more) {
      issue_rows<S>(qs0 + (buf ^ 1) * BS, qb, a.sin.t, (it + 1) * TILE, T_len, tid);
      issue_rows<S>(gs0 + (buf ^ 1) * BS, gb, a.sg.t, (it + 1) * TILE, T_len, tid);
      if (tid < TILE) read_row(next_query, next_st, next_d);
    }
    cp_async_commit();
    cp_async_wait<1>();
    uint32_t* const qt = qs0 + buf * BS;
    uint32_t* const gt = gs0 + buf * BS;
    split_chunks<S>(qt, qs_lo, qtr, a.scale, tid);
    split_chunks<S>(gt, gs_lo, gtr, 1.f, tid);
    if (tid < TILE) qrow[tid] = query_row(it * TILE + tid, cur_st, cur_d);
    // 8-query steps of this tile with a query below T; the rest add nothing
    const int n_steps = (T_len - it * TILE + 7) / 8;
    __syncthreads();
    if (row0 < T_len)  // else no key row of this warp: copies, splits and barriers only
      dkdv_tile<S, VA_SMEM>(dk, dv, ka, va, va_hi, va_lo, valid, qt, qs_lo, qtr, gt, gs_lo,
                            gtr, qrow, n_steps, lane);
    cur_st = next_st;
    cur_d = next_d;
    __syncthreads();
  }

  store_rows<S>(a.dk + a.sgrad.at(b, h, 0), a.sgrad.t, dk, a.scale, row0, T_len, lane);
  store_rows<S>(a.dv + a.sgrad.at(b, h, 0), a.sgrad.t, dv, 1.f, row0, T_len, lane);
}

template <int S>
cudaError_t launch(const BwdArgs& a, int B, cudaStream_t stream) {
  const dim3 grid(B * a.H, (a.T_len + ROWS - 1) / ROWS);
  const int nbuf = raw_buffers(a.T_len);
  cudaError_t err = launch_dyn(flash_attention_bwd_dq_tf32_kernel<S>, grid,
                               4 * dq_smem_words<S>(nbuf), stream, a);
  if (err != cudaSuccess) return err;
  return launch_dyn(flash_attention_bwd_dkdv_tf32_kernel<S>, grid,
                    4 * dkdv_smem_words<S>(nbuf), stream, a);
}

}  // namespace

// q, k, v share the (b, h, t) strides (sib, sih, sit); g and the gradients
// have their own; the S dim is contiguous in all, q, k, v and g rows start on
// 16 bytes (data pointers and strides in multiples of 4 elements) and the
// gradients' rows on 8. dq, dk and dv share (sdb, sdh, sdt). mask is (B, T)
// bytes, contiguous, or null for "all valid"; stats is the forward's (B*H*T,
// 2) float32 residual; dsum is a (B*H*T) float32 scratch.
extern "C" int mmsn_flash_attention_bwd_tf32(
    const void* q, const void* k, const void* v, const void* mask, const void* stats,
    const void* g, void* dq, void* dk, void* dv, void* dsum, int B, int H, int T_len, int S,
    float scale, int64_t sib, int64_t sih, int64_t sit, int64_t sgb, int64_t sgh, int64_t sgt,
    int64_t sdb, int64_t sdh, int64_t sdt, void* stream) {
  if (B < 1 || H < 1 || T_len < 1 || (int64_t)B * H > 0x7fffffff ||
      (T_len + ROWS - 1) / ROWS > 65535 || stats == nullptr || dsum == nullptr)
    return cudaErrorInvalidValue;
  if (!rows_aligned_f32(q, sib, sih, sit) || !rows_aligned_f32(k, sib, sih, sit) ||
      !rows_aligned_f32(v, sib, sih, sit) || !rows_aligned_f32(g, sgb, sgh, sgt) ||
      !pairs_aligned_f32(dq, sdb, sdh, sdt) || !pairs_aligned_f32(dk, sdb, sdh, sdt) ||
      !pairs_aligned_f32(dv, sdb, sdh, sdt))
    return cudaErrorInvalidValue;
  BwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.mask = static_cast<const uint8_t*>(mask);
  a.stats = static_cast<const float2*>(stats);
  a.g = static_cast<const float*>(g);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dsum = static_cast<float*>(dsum);
  a.H = H;
  a.T_len = T_len;
  a.scale = scale;
  a.sin = Strides{sib, sih, sit};
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
