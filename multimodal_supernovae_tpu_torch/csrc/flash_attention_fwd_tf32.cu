// Masked multi-head attention forward for Hopper (sm_90a) on the tensor cores,
// float32 at head dims 8 and 16, every product in 3xTF32.
//
// Replaces the Pallas TPU kernel multimodal_supernovae_tpu/ops/pallas_attention.py
// (_fwd_kernel, reached through flash_attention / _flash_fwd_impl) on the
// float32 path every shipped configuration trains on, and computes what
// csrc/flash_attention_fwd.cu (the CUDA-core kernel, which keeps head dims 32
// and 64 and rows off 16 bytes) computes for float32, which is
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
//     step's sum is added to the output on the CUDA cores (mma_rows).
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

// One 64-key tile of one warp's 16 rows: scores, online softmax, o += P . V.
template <int S>
__device__ __forceinline__ void fwd_tile(float (&o)[S / 8][4], float (&m)[2], float (&l)[2],
                                         const FragA (&qa)[S / 8], const uint32_t* khi,
                                         const uint32_t* klo, const uint32_t* vtr,
                                         const uint8_t* kind, int lane) {
  const int t = lane & 3;
  // scores of 16 rows x 64 keys: 8 C fragments, key 8j + 2t + (e & 1)
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mma_head<S>(s[j], qa, khi, klo, 8 * j, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint8_t kd = kind[8 * j + 2 * t + (e & 1)];
      s[j][e] = kd == 0 ? s[j][e] : (kd == 1 ? MASK_FILL_LOG2 : -INFINITY);
    }
  }
  // Key it*64 < T is in every tile, so the new max is finite: exp2 of -inf
  // (+0 on ex2.approx) drops the empty state, and an all-masked earlier tile
  // (max -1e7 * log2e) is wiped by the first valid key, as exp2 underflows.
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
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
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2_approx(s[j][e] - m[e >> 1]);
      l[e >> 1] += s[j][e];
    }
    mma_rows<S>(o, s[j], vtr, 8 * j, lane);  // o += P . V over keys 8j ..
  }
}

// Dynamic shared memory, in words: K's row tiles (k * c; the cp.async target,
// TF32 hi after the split) x 2, K's lo tile, V's raw row tiles x 2, V's
// transposed tile, then the key kinds x 2.
template <int S>
constexpr int fwd_smem_words() {
  return 3 * LayoutF<S>::TS + 2 * LayoutF<S>::TS + LayoutF<S>::TT + 2 * TILE / 4;
}

template <int S>
__global__ void __launch_bounds__(THREADS) flash_attention_fwd_tf32_kernel(const FwdArgs a) {
  using L = LayoutF<S>;
  static_assert(TILE == 64, "fwd_tile takes 8 steps of 8 keys");
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* const ks0 = smem;  // + buf * TS: the row tile of buffer buf
  uint32_t* const ks_lo = smem + 2 * L::TS;
  uint32_t* const vraw0 = smem + 3 * L::TS;
  uint32_t* const vtr = smem + 5 * L::TS;
  // each key's kind: 0 valid, 1 masked, 2 past T
  uint8_t(*kind)[TILE] = reinterpret_cast<uint8_t(*)[TILE]>(vtr + L::TT);

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
  float4 no_shift[L::CH];
#pragma unroll
  for (int i = 0; i < L::CH; ++i) no_shift[i] = make_float4(0.f, 0.f, 0.f, 0.f);

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
      issue_rows<S>(ks0 + (buf ^ 1) * L::TS, kb, a.sin.t, (it + 1) * TILE, T_len, tid);
      issue_rows<S>(vraw0 + (buf ^ 1) * L::TS, vb, a.sin.t, (it + 1) * TILE, T_len, tid);
      if (tid < TILE) next_byte = mask_byte(mrow, next_key, T_len);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (the next tile's may be in flight)
    split_chunks<S>(ks0 + buf * L::TS, ks_lo, nullptr, a.scale, no_shift, tid);
    split_chunks<S>(vraw0 + buf * L::TS, nullptr, vtr, 1.f, no_shift, tid);
    __syncthreads();
    fwd_tile<S>(o, m, l, qa, ks0 + buf * L::TS, ks_lo, vtr, kind[buf], lane);
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

template <int S>
cudaError_t launch(const FwdArgs& a, int B, cudaStream_t stream) {
  const dim3 grid(B * a.H, (a.T_len + ROWS - 1) / ROWS);
  return launch_dyn(flash_attention_fwd_tf32_kernel<S>, grid, 4 * fwd_smem_words<S>(), stream,
                    a);
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
    default:
      return cudaErrorInvalidValue;
  }
}
