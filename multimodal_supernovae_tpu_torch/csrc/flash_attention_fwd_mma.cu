// Masked multi-head attention forward for Hopper (sm_90a) on the tensor cores,
// bf16 at head dims 8, 16, 32 and 64.
//
// Replaces the Pallas TPU kernel multimodal_supernovae_tpu/ops/pallas_attention.py
// (_fwd_kernel, reached through flash_attention / _flash_fwd_impl) on the
// bf16 main path, and computes what csrc/flash_attention_fwd.cu (the CUDA-core
// kernel, which keeps the other head dims and rows off 16 bytes) computes,
// which is
// ops/attention.py:dense_attention of this package: qs = bf16(q * c) and
// ks = bf16(k * c) with c = emb**-0.25 (emb = H * S, the FULL width); float32
// scores qs . ks; a key j < T with mask[b, j] false gets the score -1e7 (a fully
// masked row is uniform over its T keys) and keys past T are excluded; P
// rounded to bf16 before P . V, float32 accumulation, the output divided by the
// float32 row sum of the unrounded P. Those rounding points are exactly the
// operand types of mma.sync (bf16 in, float32 accumulate), so the products
// need no extra casts. P is rounded relative to the running max (online
// softmax), as in the CUDA-core kernel.
//
// What bounds it on this card: not the products. At head dim 8 or 16 each
// score costs 2 * S multiply-adds, a few hundredths of a nanosecond of tensor
// core, but one exponential on the MUFU pipe (16 a clock an SM) and some five
// float32 operations (scale, max, subtract, sum, convert), plus the mask's
// selects. The exponentials alone take 0.13 ms at the spectral serving shape
// (256, 2, 1024, 16); the kernel takes about twice that, and what it waits on
// beyond them is not yet known (PERF.md, open questions). The CUDA-core kernel
// spent 2 * S float32 FMAs a score on top and held 122 registers at S = 16.
// The design moves both products onto the tensor cores so the CUDA cores and
// the MUFU pipe do only the softmax:
//   * grid (B*H, ceil(T/64)), 4 warps a block, 16 query rows a warp; a warp
//     keeps its qs as an mma A fragment in registers for the whole key loop;
//   * K/V tiles of 64 keys, bf16 in shared memory, double-buffered with
//     cp.async (zero-filled past T); each thread rounds the K chunks it copied
//     to bf16(k * c) in place before the barrier that publishes the tile;
//   * S = qs . ks^T with S / 16 chained m16n8k16 (S = 16, 32, 64) or m16n8k8
//     (S = 8), K fragments by ldmatrix; masking and the online softmax on
//     the float32 C fragments in the log2 domain (one ex2.approx per
//     score). A tile whose 64 keys are all valid (the block's vote at the
//     barrier, __syncthreads_and) skips the mask's selects and takes each
//     exponent's argument in one FMA;
//   * P . V with m16n8k16, P's C fragments of two adjacent 8-key tiles packed
//     to bf16 as the A fragment, V fragments by ldmatrix.trans;
//   * a warp whose 16 rows all lie past T (the fourth of the ViT's T = 36)
//     keeps to the copies and barriers and skips the tile's compute.
// At head dims 32 and 64 (the ViT image tower at 4 and 2 heads) the same
// design holds: qs is S / 4 registers a lane and the output accumulator S / 2,
// so at S = 64 a warp keeps 16 + 32 + the tile's 32 score registers (168 in
// all, no spill); at S = 32 ptxas holds the kernel to 128 registers and
// spilled a whole tile's scores, so there the tile is taken in two 32-key
// steps, each with its own online rescale (no spill, the same time:
// probe_flash_tc_steps.py). The shared rows are padded to 80 and 144 bytes
// (csrc/flash_attention_mma.cuh), 37 KB of static shared memory at S = 64.
// At the ViT's T = 36 one tile covers a row. Each score there costs
// 2 * S multiply-adds on the tensor cores beside its exponential; the
// CUDA-core kernel ran them as float32 FMAs, one query row a thread (36 of
// a block's 128 threads busy at T = 36).
//
// Training residual: given a non-null ``stats``, each row also stores its final
// (max in the log2 domain, sum) in float32 as (B*H*T, 2), the contract of
// csrc/flash_attention_fwd.cu, so either forward feeds either backward.
//
// Plain C interface, loaded with ctypes (kernels/build.py): the entry returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape,
// head dim or alignment it does not take. It launches on the given stream,
// does not synchronise and allocates nothing.

#include "flash_attention_mma.cuh"

#include <cmath>

namespace {

using namespace flash_mma;

struct FwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const uint8_t* mask;  // (B, T) bytes or null
  bf16* out;
  float2* stats;        // (B*H*T) rows' (max in the log2 domain, sum), or null
  int H, T_len;
  float scale;
  Strides sin, sout;    // q, k, v share sin
};

// Keys k0 .. k0 + 8 NJ - 1 of a 64-key tile for one warp's 16 rows: scores,
// online softmax, o += P . V. NJ is 8 (the whole tile) or 4 (half of it, at
// head dim 32: 16 score registers fewer). DENSE: every key of the tile is valid (the block agreed
// at the barrier), so no key needs the mask's fill and each exponent is one
// FMA off the raw score.
template <int S, int NJ, bool DENSE>
__device__ __forceinline__ void fwd_tile(float (&o)[S / 8][4], float (&m)[2], float (&l)[2],
                                         const uint32_t (&qa)[S / 4], const bf16* ks,
                                         const bf16* vs, const uint8_t* kind, int k0,
                                         int lane) {
  const int t = lane & 3;
  // scores of 16 rows x 8 NJ keys: NJ C fragments, key k0 + 8j + 2t + (e & 1)
  float s[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; j += 2) {
    uint32_t kf[2][S / 8];
    ldsm_rows<S>(kf, ks, k0 + 8 * j, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) mma_head<S>(s[j + i], qa, kf[i]);
  }
  if constexpr (!DENSE) {  // to the log2 domain, with the mask's fill
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint8_t kd = kind[k0 + 8 * j + 2 * t + (e & 1)];
        s[j][e] = kd == 0 ? s[j][e] * LOG2E : (kd == 1 ? MASK_FILL_LOG2 : -INFINITY);
      }
    }
  }
  const float mx[2] = {row_max<NJ>(s, 0), row_max<NJ>(s, 1)};
  // The caller skips a step whose keys all lie past T, and key 0 of every
  // tile's first step is below T, so the new max is finite: exp2 of -inf
  // drops the empty state, and an all-masked earlier step (max -1e7 * log2e)
  // is wiped by the first valid key, as exp2 underflows. A dense tile's max is
  // rounded from the raw one: rounding is monotonic, so it is the largest
  // rounded score, as the masked path takes it.
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float tile_max = DENSE ? quad_max(mx[r]) * LOG2E : quad_max(mx[r]);
    const float m_new = fmaxf(m[r], tile_max);
    alpha[r] = exp2_approx(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < S / 8; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = DENSE ? exp2_approx(fmaf(s[j][e], LOG2E, -m[e >> 1]))
                      : exp2_approx(s[j][e] - m[e >> 1]);
    }
  }
  l[0] += row_sum<NJ>(s, 0);
  l[1] += row_sum<NJ>(s, 1);
  // o += bf16(P) . V, 16 keys a step
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    uint32_t pa[4];
    c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
    uint32_t vf[S / 8][2];
    ldsm_cols<S>(vf, vs, k0 + 16 * kk, lane);
#pragma unroll
    for (int n = 0; n < S / 8; ++n) mma_k16(o[n], pa, vf[n][0], vf[n][1]);
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS) flash_attention_fwd_mma_kernel(const FwdArgs a) {
  using L = Layout<S>;
  static_assert(TILE == 64, "fwd_tile takes 8 tiles of 8 keys");
  // 8-key columns a step of fwd_tile: two 32-key steps a tile at S = 32, where
  // one step spills (ptxas keeps 128 registers there), one elsewhere
  constexpr int NJ = S == 32 ? 4 : 8;
  __shared__ __align__(16) bf16 ks[2][TILE * L::RS];
  __shared__ __align__(16) bf16 vs[2][TILE * L::RS];
  __shared__ uint8_t kind[2][TILE];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int T_len = a.T_len;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int64_t base = a.sin.at(b, h, 0);
  const bf16* kb = a.k + base;
  const bf16* vb = a.v + base;
  const uint8_t* mrow = a.mask != nullptr ? a.mask + (int64_t)b * T_len : nullptr;
  const int row0 = blockIdx.y * ROWS + warp * 16;

  uint32_t qa[S / 4];
  load_a<S>(qa, a.q + base, a.sin.t, row0, T_len, a.scale, true, lane);

  float o[S / 8][4];
#pragma unroll
  for (int n = 0; n < S / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8 (log2 domain)
  float l[2] = {0.f, 0.f};              // this thread's share of the running sums

  const int n_tiles = (T_len + TILE - 1) / TILE;
  issue_tile<S>(ks[0], vs[0], kb, vb, a.sin.t, a.sin.t, 0, T_len, tid);
  cp_async_commit();
  // this thread's key kind in the current tile (threads past TILE own none)
  uint8_t my_kind = tid < TILE ? key_kind(mrow, tid, T_len) : 0;
  if (tid < TILE) kind[0][tid] = my_kind;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const bool more = it + 1 < n_tiles;
    const int next_key = (it + 1) * TILE + tid;
    uint8_t next_byte = 1;
    if (more) {  // the next tile's buffer was released by the last barrier
      issue_tile<S>(ks[buf ^ 1], vs[buf ^ 1], kb, vb, a.sin.t, a.sin.t, (it + 1) * TILE,
                    T_len, tid);
      if (tid < TILE) next_byte = mask_byte(mrow, next_key, T_len);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (the next tile's may be in flight)
    scale_own_chunks<S>(ks[buf], a.scale, tid);
    const bool dense = __syncthreads_and(my_kind == 0);
    if (row0 >= T_len) {  // no row of this warp: copies and barriers only
    } else if constexpr (NJ == 8) {  // the whole tile in one step
      if (dense) {
        fwd_tile<S, NJ, true>(o, m, l, qa, ks[buf], vs[buf], kind[buf], 0, lane);
      } else {
        fwd_tile<S, NJ, false>(o, m, l, qa, ks[buf], vs[buf], kind[buf], 0, lane);
      }
    } else {
#pragma unroll
      for (int k0 = 0; k0 < TILE; k0 += 8 * NJ) {
        if (it * TILE + k0 >= T_len) break;  // the rest of the tile lies past T
        if (dense) {
          fwd_tile<S, NJ, true>(o, m, l, qa, ks[buf], vs[buf], kind[buf], k0, lane);
        } else {
          fwd_tile<S, NJ, false>(o, m, l, qa, ks[buf], vs[buf], kind[buf], k0, lane);
        }
      }
    }
    my_kind = tid < TILE ? kind_of(next_byte, next_key, T_len) : 0;
    if (more && tid < TILE) kind[buf ^ 1][tid] = my_kind;
    __syncthreads();  // this tile's buffers are free for the tile after next
  }

  const int g = lane >> 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    const int row = row0 + g + 8 * r;
    if (row >= T_len) continue;
    const float inv = 1.f / sum;
    bf16* orow = a.out + a.sout.at(b, h, row);
#pragma unroll
    for (int n = 0; n < S / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) =
          pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
    if (a.stats != nullptr && t == 0) a.stats[(int64_t)bh * T_len + row] = make_float2(m[r], sum);
  }
}

template <int S>
cudaError_t launch(const FwdArgs& a, int B, cudaStream_t stream) {
  const dim3 grid(B * a.H, (a.T_len + ROWS - 1) / ROWS);
  flash_attention_fwd_mma_kernel<S><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, k, v share the strides (sib, sih, sit) of their (B, H, T) dims and out
// has (sob, soh, sot); the S dim is contiguous in all four, and every row
// starts on 16 bytes (data pointers and strides in multiples of 8 elements).
// mask is (B, T) bytes, contiguous, or null for "all valid". stats is null or
// (B*H*T, 2) float32, contiguous: the rows' (max, sum).
extern "C" int mmsn_flash_attention_fwd_mma(
    const void* q, const void* k, const void* v, const void* mask, void* out, void* stats,
    int B, int H, int T_len, int S, float scale, int64_t sib, int64_t sih, int64_t sit,
    int64_t sob, int64_t soh, int64_t sot, void* stream) {
  if (B < 1 || H < 1 || T_len < 1 || (int64_t)B * H > 0x7fffffff ||
      (T_len + ROWS - 1) / ROWS > 65535)
    return cudaErrorInvalidValue;
  if (!rows_aligned(q, sib, sih, sit) || !rows_aligned(k, sib, sih, sit) ||
      !rows_aligned(v, sib, sih, sit) || sob % 2 || soh % 2 || sot % 2 ||
      reinterpret_cast<uintptr_t>(out) % 4)
    return cudaErrorInvalidValue;
  FwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = static_cast<bf16*>(out);
  a.stats = static_cast<float2*>(stats);
  a.H = H;
  a.T_len = T_len;
  a.scale = scale;
  a.sin = Strides{sib, sih, sit};
  a.sout = Strides{sob, soh, sot};
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
