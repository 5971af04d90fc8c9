// Masked multi-head attention forward for Hopper (sm_90a) on the tensor cores,
// float32 at head dims 8, 16, 32 and 64, every product in 3xTF32.
//
// Replaces the Pallas TPU kernel multimodal_supernovae_tpu/ops/pallas_attention.py
// (_fwd_kernel, reached through flash_attention / _flash_fwd_impl) on the
// float32 path every shipped configuration trains on, and computes what
// csrc/flash_attention_fwd.cu (the CUDA-core kernel, which keeps the other
// head dims and rows off 16 bytes) computes for float32, which is
// ops/attention.py:dense_attention of this package: with c = emb**-0.25
// (emb = H * S, the FULL width), scores (q * c) . (k * c) in float32, taken in
// the log2 domain (q * c carries a factor log2(e), so each exponential is
// one ex2.approx, relative error about 2^-22); a key j < T with mask[b, j]
// false gets the score -1e7 (times log2(e)), so a fully masked row is
// uniform over its T keys; keys past T are excluded; float32 P . V, the
// output divided by the row sum. Both products run as three TF32 mma.sync
// each (lo . hi, hi . lo, hi . hi, csrc/tf32x3.cuh): one TF32 product keeps
// about 1e-4 relative error, which the exponential would carry into every
// probability; three keep about float32's.
//
// What bounds it on this card: at head dim 8 or 16 each score costs 2 * S
// multiply-adds in each product, 4 * S in all, three TF32 passes of them on
// the tensor cores (0.208 ms at the spectral serving shape (256, 2, 1024, 16)
// at 495 TFLOP/s), against one exponential on the MUFU pipe (0.128 ms there)
// and some ten float32 operations for the mask, the online softmax and the
// split of P into TF32 halves. The CUDA-core kernel spends the 4 * S
// multiply-adds as float32 FMAs at 67 TFLOP/s (0.513 ms there). The design
// follows the bf16 tensor-core kernel (csrc/flash_attention_fwd_mma.cu):
//   * grid (B*H, ceil(T/64)), 4 warps a block, 16 query rows a warp; a warp
//     keeps its q * c * log2(e), split, as S/8 A fragments for the whole key
//     loop;
//   * K/V tiles of 64 keys streamed by cp.async, double-buffered (zero-filled
//     past T); each thread splits the chunks it copied once a block: K (as
//     k * c) into TF32 hi and lo row tiles, which the scores read by
//     ldmatrix, V into a transposed tile of (hi, lo) pairs, which P . V reads
//     16 bytes a B fragment (csrc/flash_attention_tf32.cuh). The 4 warps read
//     pre-split B fragments; 35 KB of dynamic shared memory at S = 16;
//   * scores with m16n8k8, each TF32 pass in its own accumulator (the chains
//     stay S/8 long), masking and the online softmax on the float32 C
//     fragments (quad shuffles for each row's max; each lane keeps its share
//     of the row sum);
//   * P . V with m16n8k8: each 8-key step's C fragment is the A fragment of
//     the next product with the key index permuted within the step (C columns
//     2t, 2t + 1 as A columns t, t + 4), V's B fragment read at keys 2t and
//     2t + 1 to match; P is split into hi/lo in registers, and each 8-key
//     step's sum is added to the output on the CUDA cores (mma_rows);
//   * a warp whose 16 rows all lie past T (the fourth of the ViT's T = 36)
//     keeps to the copies, splits and barriers and skips the tile's compute.
// At head dims 32 and 64 (the ViT image tower at 4 and 2 heads) the design is
// the same, but for the step: at S = 64 a lane holds q's 8 split A fragments
// (64 registers) and the output accumulator (32), and a whole tile's scores
// (32 more) spilled, so at S = 32 and 64 a tile is taken in two 32-key steps,
// each with its own online rescale (179 registers at S = 64, no spill; each
// score's three passes chain over the k-steps in their own accumulators, one
// 8-key column at a time). The tiles take 65 KB of dynamic shared memory at
// S = 32 (3 blocks an SM) and 124 KB at S = 64 (one block an SM); at T <= 64
// the raw tiles are single (raw_buffers): 46 and 89 KB, 4 and 2 blocks an SM.
// At the ViT's T = 36 one tile covers a row, and its second step (keys
// 32-63) only four keys. A step whose keys all lie past T is skipped. The CUDA-core
// kernel spent the 4 * S multiply-adds a score as float32 FMAs, one query
// row a thread (36 of a block's 128 busy at T = 36).
//
// Training residual: given a non-null ``stats``, each row also stores its final
// (max in the log2 domain, sum) in float32 as (B*H*T, 2), the contract of
// csrc/flash_attention_fwd.cu, so either forward feeds either backward.
//
// Plain C interface, loaded with ctypes (kernels/build.py): the entry returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape,
// head dim or alignment it does not take. It launches on the given stream,
// does not synchronise and allocates nothing.

#include "flash_attention_tf32.cuh"

#include <cmath>

namespace {

using namespace flash_tf32;

struct FwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const uint8_t* mask;  // (B, T) bytes or null
  float* out;
  float2* stats;        // (B*H*T) rows' (max in the log2 domain, sum), or null
  int H, T_len;
  float scale;
  Strides sin, sout;    // q, k, v share sin
};

// Keys k0 .. k0 + 8 NJ - 1 of a 64-key tile for one warp's 16 rows: scores,
// online softmax, o += P . V. NJ is 8 (the whole tile) or 4 (half of it, at
// head dims 32 and 64: 16 score registers fewer beside q's 2S and the
// output's S / 2).
template <int S, int NJ>
__device__ __forceinline__ void fwd_tile(float (&o)[S / 8][4], float (&m)[2], float (&l)[2],
                                         const FragA (&qa)[S / 8], const uint32_t* khi,
                                         const uint32_t* klo, const uint32_t* vtr,
                                         const uint8_t* kind, int k0, int lane) {
  const int t = lane & 3;
  // scores of 16 rows x 8 NJ keys: NJ C fragments, key k0 + 8j + 2t + (e & 1)
  float s[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    mma_head<S>(s[j], qa, khi, klo, k0 + 8 * j, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint8_t kd = kind[k0 + 8 * j + 2 * t + (e & 1)];
      s[j][e] = kd == 0 ? s[j][e] : (kd == 1 ? MASK_FILL_LOG2 : -INFINITY);
    }
  }
  // The caller skips a step whose keys all lie past T, and key 0 of every
  // tile's first step is below T, so the new max is finite: exp2 of -inf
  // (+0 on ex2.approx) drops the empty state, and an all-masked earlier step
  // (max -1e7 * log2e) is wiped by the first valid key, as exp2 underflows.
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    const float m_new = fmaxf(m[r], quad_max(mx));
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
      s[j][e] = exp2_approx(s[j][e] - m[e >> 1]);
      l[e >> 1] += s[j][e];
    }
    mma_rows<S>(o, s[j], vtr, k0 + 8 * j, lane);  // o += P . V over keys k0 + 8j ..
  }
}

// Dynamic shared memory, in words: K's lo tile, V's transposed tile, the key
// kinds x 2, then for each of nbuf = raw_buffers(T) buffers K's row tile (k *
// c; the cp.async target, TF32 hi after the split) and V's raw row tile. The
// buffers come last, so every offset is a constant and one buffer is only a
// shorter allocation.
template <int S>
int fwd_smem_words(int nbuf) {
  return LayoutF<S>::TS + LayoutF<S>::TT + 2 * TILE / 4 + nbuf * 2 * LayoutF<S>::TS;
}

template <int S>
__global__ void __launch_bounds__(THREADS) flash_attention_fwd_tf32_kernel(const FwdArgs a) {
  using L = LayoutF<S>;
  static_assert(TILE == 64, "fwd_tile takes 8 steps of 8 keys");
  constexpr int NJ = S >= 32 ? 4 : 8;  // 8-key columns a step of fwd_tile
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int BS = 2 * L::TS;  // words from one buffer's raw tiles to the next's
  uint32_t* const ks_lo = smem;
  uint32_t* const vtr = smem + L::TS;
  // each key's kind: 0 valid, 1 masked, 2 past T
  uint8_t(*kind)[TILE] = reinterpret_cast<uint8_t(*)[TILE]>(vtr + L::TT);
  uint32_t* const ks0 = vtr + L::TT + 2 * TILE / 4;  // + buf * BS: buffer buf's tiles
  uint32_t* const vraw0 = ks0 + L::TS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T_len = a.T_len;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int64_t base = a.sin.at(b, h, 0);
  const float* kb = a.k + base;
  const float* vb = a.v + base;
  const uint8_t* mrow = a.mask != nullptr ? a.mask + (int64_t)b * T_len : nullptr;
  const int row0 = blockIdx.y * ROWS + warp * 16;

  FragA qa[S / 8];
  {
    float x[S / 8][4];
    load_rows<S>(x, a.q + base, a.sin.t, row0, T_len, lane);
#pragma unroll
    for (int ks_ = 0; ks_ < S / 8; ++ks_) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[ks_][e] = x[ks_][e] * a.scale * LOG2E;
      split_a(qa[ks_], x[ks_]);
    }
  }

  float o[S / 8][4];
#pragma unroll
  for (int n = 0; n < S / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8 (log2 domain)
  float l[2] = {0.f, 0.f};              // this lane's share of the running sums
  const int n_tiles = (T_len + TILE - 1) / TILE;
  issue_rows<S>(ks0, kb, a.sin.t, 0, T_len, tid);
  issue_rows<S>(vraw0, vb, a.sin.t, 0, T_len, tid);
  cp_async_commit();
  if (tid < TILE) kind[0][tid] = key_kind(mrow, tid, T_len);

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const bool more = it + 1 < n_tiles;
    const int next_key = (it + 1) * TILE + tid;
    uint8_t next_byte = 1;
    if (more) {  // the next tile's buffers were released by the last barrier
      issue_rows<S>(ks0 + (buf ^ 1) * BS, kb, a.sin.t, (it + 1) * TILE, T_len, tid);
      issue_rows<S>(vraw0 + (buf ^ 1) * BS, vb, a.sin.t, (it + 1) * TILE, T_len, tid);
      if (tid < TILE) next_byte = mask_byte(mrow, next_key, T_len);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (the next tile's may be in flight)
    split_chunks<S>(ks0 + buf * BS, ks_lo, nullptr, a.scale, tid);
    split_chunks<S>(vraw0 + buf * BS, nullptr, vtr, 1.f, tid);
    __syncthreads();
    if (row0 >= T_len) {  // no row of this warp: copies, splits and barriers only
    } else if constexpr (NJ == 8) {  // the whole tile in one step
      fwd_tile<S, NJ>(o, m, l, qa, ks0 + buf * BS, ks_lo, vtr, kind[buf], 0, lane);
    } else {
#pragma unroll
      for (int k0 = 0; k0 < TILE; k0 += 8 * NJ) {
        if (it * TILE + k0 >= T_len) break;  // the rest of the tile lies past T
        fwd_tile<S, NJ>(o, m, l, qa, ks0 + buf * BS, ks_lo, vtr, kind[buf], k0, lane);
      }
    }
    if (more && tid < TILE) kind[buf ^ 1][tid] = kind_of(next_byte, next_key, T_len);
    __syncthreads();  // this tile's tiles are free: the lo and transposed ones for the next
  }

  const int g = lane >> 2, t = lane & 3;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    inv[r] = 1.f / sum;
    const int row = row0 + g + 8 * r;
    if (a.stats != nullptr && t == 0 && row < T_len)
      a.stats[(int64_t)bh * T_len + row] = make_float2(m[r], sum);
  }
#pragma unroll
  for (int n = 0; n < S / 8; ++n) {
    o[n][0] *= inv[0];
    o[n][1] *= inv[0];
    o[n][2] *= inv[1];
    o[n][3] *= inv[1];
  }
  store_rows<S>(a.out + a.sout.at(b, h, 0), a.sout.t, o, 1.f, row0, T_len, lane);
}

// The 3xTF32 arithmetic alone, for holding it bit for bit to the CPU model of
// tests/test_torch_flash_tf32.py: split_tf32 of x[0 .. n), and the three
// passes of one m16n8k8 tile of a (16 x 8, row-major) and b (8 x 8, k rows of
// 8 columns), each from a zero accumulator: c = (lo_a . hi_b, hi_a . lo_b,
// hi_a . hi_b), 3 x 16 x 8 row-major.
__global__ void tf32_check_kernel(const float* x, uint32_t* hi, uint32_t* lo, int n,
                                  const float* a, const float* b, float* c) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    split_tf32(x[i], hi[i], lo[i]);
  if (blockIdx.x != 0 || threadIdx.x >= 32) return;
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const float av[4] = {a[g * 8 + t], a[(g + 8) * 8 + t], a[g * 8 + t + 4],
                       a[(g + 8) * 8 + t + 4]};
  FragA fa;
  split_a(fa, av);
  FragB fb;
  split_tf32(b[t * 8 + g], fb.hi[0], fb.lo[0]);
  split_tf32(b[(t + 4) * 8 + g], fb.hi[1], fb.lo[1]);
  float p[3][4] = {};
  mma_tf32(p[0], fa.lo, fb.hi);
  mma_tf32(p[1], fa.hi, fb.lo);
  mma_tf32(p[2], fa.hi, fb.hi);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[k * 128 + (g + 8 * (e >> 1)) * 8 + 2 * t + (e & 1)] = p[k][e];
  }
}

template <int S>
cudaError_t launch(const FwdArgs& a, int B, cudaStream_t stream) {
  const dim3 grid(B * a.H, (a.T_len + ROWS - 1) / ROWS);
  return launch_dyn(flash_attention_fwd_tf32_kernel<S>, grid,
                    4 * fwd_smem_words<S>(raw_buffers(a.T_len)), stream, a);
}

}  // namespace

// q, k, v share the strides (sib, sih, sit) of their (B, H, T) dims and out
// has (sob, soh, sot); the S dim is contiguous in all four, q, k and v rows
// start on 16 bytes (data pointers and strides in multiples of 4 elements)
// and out rows on 8. mask is (B, T) bytes, contiguous, or null for "all
// valid". stats is null or (B*H*T, 2) float32, contiguous: the rows' (max,
// sum).
extern "C" int mmsn_flash_attention_fwd_tf32(
    const void* q, const void* k, const void* v, const void* mask, void* out, void* stats,
    int B, int H, int T_len, int S, float scale, int64_t sib, int64_t sih, int64_t sit,
    int64_t sob, int64_t soh, int64_t sot, void* stream) {
  if (B < 1 || H < 1 || T_len < 1 || (int64_t)B * H > 0x7fffffff ||
      (T_len + ROWS - 1) / ROWS > 65535)
    return cudaErrorInvalidValue;
  if (!rows_aligned_f32(q, sib, sih, sit) || !rows_aligned_f32(k, sib, sih, sit) ||
      !rows_aligned_f32(v, sib, sih, sit) || !pairs_aligned_f32(out, sob, soh, sot))
    return cudaErrorInvalidValue;
  FwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = static_cast<float*>(out);
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

// The check entry of tf32_check_kernel: x (n float32), hi and lo (n 32-bit
// words), a (16 x 8), b (8 x 8) and c (3 x 16 x 8) float32, all contiguous on
// the card.
extern "C" int mmsn_flash_attention_tf32_check(const void* x, void* hi, void* lo, int n,
                                               const void* a, const void* b, void* c,
                                               void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  int blocks = (n + 255) / 256;
  blocks = blocks < 1 ? 1 : blocks > 1024 ? 1024 : blocks;
  tf32_check_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint32_t*>(hi), static_cast<uint32_t*>(lo), n,
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c));
  return cudaGetLastError();
}
