// Masked multi-head attention backward for Hopper (sm_90a), CUDA cores only.
//
// Replaces the Pallas TPU kernel multimodal_supernovae_tpu/ops/pallas_attention.py
// (_bwd_kernel, reached through _flash_bwd) and computes the gradient of
// ops/attention.py:dense_attention of this package. With c = emb**-0.25,
// qs = round(q*c), ks = round(k*c) (rounded to the input dtype, as the forward
// rounds them), P = softmax(mask(qs . ks)) in float32 with masked keys at -1e7:
//   dP = g . v^T                         (float32 accumulation)
//   D  = rowsum(P o dP)                  (the reference's; see below)
//   dS = P o (dP - D), zeroed at masked keys, rounded to q's dtype
//   dq = dS . ks * c,  dk = dS^T . qs * c,  dv = round(P)^T . g
// dq/dk/dv are stored in the input dtype. In a fully masked row P is uniform
// over its T keys, so dv at a masked key is not zero while dk and dq are.
//
// D is rowsum(P o dP), as the reference _bwd_kernel and the plain version
// take it: the dq kernel sums it in a first pass over the keys and writes it
// to a float32 scratch that the dk/dv kernel reads. Where a row's values are
// nearly equal across its keys (deep layers of an encoder), dP - D cancels and
// any error of D comes through whole. D = g . out (the forward output's
// rounding) put dq 4-10x farther from a float64 reference than the plain
// version on the model's own float32 activations, and so did a running
// float32 sum of P dP over 200 keys, whose error grows with the key count
// (the plain version sums in a tree). So D is summed as c0 + rowsum(P o (dP -
// c0)), c0 = dP of key 0: its terms are of the size of dP - D
// (chip_smoke.py, phase grad-probe; tests/test_torch_flash_kernel.py pins
// it). This kernel does not read the forward's output.
//
// Design. The TPU kernel accumulates dk/dv across q-tiles by revisiting one
// output block, which relies on the TPU grid running in order. Blocks on this
// card run in no order, so the work is split into two kernels that each own
// their outputs and need no atomics (deterministic):
//   * dq kernel, grid (B*H, ceil(T/BQ)): one thread per query row, shaped like
//     the forward; it keeps qs, g and the dq accumulator in float32 registers
//     and walks K/V in BK-key tiles staged in shared memory (broadcast reads),
//     twice: D first, then dS and dq;
//   * dk/dv kernel, grid (B*H, ceil(T/BKV)): one thread per key row; it keeps
//     ks, v and the dk/dv accumulators in registers and walks the queries in
//     BQT-row tiles of (qs, g, max, 1/sum, D) staged in shared memory.
// Both rebuild P from the forward's per-row (max, sum) residual, so no max or
// sum pass is repeated. Scores are in the log2 domain (a log2(e) factor on q or
// k), as in the forward, so every exponential is one exp2f.
//
// What bounds it on this card: CUDA-core compute, like the forward. Per (query,
// key) pair the dq kernel does 3*S FMAs and one exponential, the dk/dv kernel
// 4*S and one exponential; device memory sees q/k/v/g once per tile. The
// D pass adds 2*S FMAs and one exponential a pair to the dq kernel. At head
// dims 8, 16 and 32 with 16-byte rows, bf16 takes csrc/flash_attention_bwd_mma.cu
// and float32 csrc/flash_attention_bwd_tf32.cu instead.
//
// Head dims. Both kernels are instantiated at a capacity S in {4, 8, 16, 32,
// 64} and take the true head dim s <= S at run time: loads past s read 0 and
// stores past s are skipped, and the zero columns change no q . k and no
// g . v, so every head dim from 1 to 64 gives the dense results with no
// padded copy. At S = 64 one thread's four S-wide rows (k, v, dk, dv in the
// dk/dv kernel; q, g, dq in the dq kernel) would pass the 255-register limit,
// so each row is split over two neighbouring threads of a warp, each owning
// S/2 columns: the two halves of a score and of dP are joined by one
// __shfl_xor_sync, both threads then take the same P and dS, and each
// updates its own columns. A block then covers 64 rows.
//
// Plain C interface, loaded with ctypes (kernels/build.py): the entry launches
// both kernels on the given stream and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or dtype it does not take. It does not
// synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int BQ = 128;   // dq kernel: query rows per block, one per thread
constexpr int BK = 32;    // dq kernel: keys per shared-memory tile
constexpr int BKV = 128;  // dk/dv kernel: key rows per block, one per thread
constexpr int BQT = 32;   // dk/dv kernel: query rows per shared-memory tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK_FILL_LOG2 = -1e7f * LOG2E;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round through the storage dtype (the identity for float).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// (b, h, t) element strides of one (B, H, T, S) tensor; S is contiguous.
struct Strides {
  int64_t b, h, t;
  __device__ __forceinline__ int64_t at(int b_, int h_, int t_) const {
    return b_ * b + h_ * h + t_ * this->t;
  }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;  // (B, T) bytes or null
  const float2* stats;  // (B*H*T) rows' (max in the log2 domain, sum)
  const void* g;
  void* dq;
  void* dk;
  void* dv;
  float* dsum;          // (B*H*T) scratch: D = rowsum(P o dP) of each row
  int H, T_len, S;  // S: the true head dim, at most the kernels' capacity
  float scale;
  Strides sqkv, sg, sgrad;  // sgrad: dq, dk and dv
};

// Threads a row at capacity S: two at 64, each owning S/2 columns (see the
// design note above), one below.
template <int S>
struct Split {
  static constexpr int N = S == 64 ? 2 : 1;
  static constexpr int W = S / N;  // columns a thread owns
};

// The sum of a row's partial dot products over the threads that share it.
template <int N>
__device__ __forceinline__ float row_sum(float x) {
  if constexpr (N == 2) x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

template <typename T, int S>
__global__ void __launch_bounds__(BQ) flash_attention_bwd_dq_kernel(const Args a) {
  static_assert(S % 4 == 0, "head dim capacity must be a multiple of 4");
  using SP = Split<S>;
  constexpr int W = SP::W;
  __shared__ __align__(16) float ks[BK][S];
  __shared__ __align__(16) float vs[BK][S];
  __shared__ uint8_t kind[BK];  // 0 valid key, 1 masked key, 2 past T

  const int T_len = a.T_len, s_dim = a.S;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int row = blockIdx.y * (BQ / SP::N) + threadIdx.x / SP::N;
  const int col0 = (threadIdx.x % SP::N) * W;  // this thread's first column
  const bool active = row < T_len;
  const T* q = static_cast<const T*>(a.q);
  const T* kb = static_cast<const T*>(a.k) + a.sqkv.at(b, h, 0);
  const T* vb = static_cast<const T*>(a.v) + a.sqkv.at(b, h, 0);

  float qr[W], gr[W], acc[W];
  float m = 0.f, inv_l = 0.f, D = 0.f, c0 = 0.f;  // inactive rows: p = 0 below
#pragma unroll
  for (int d = 0; d < W; ++d) {
    qr[d] = 0.f;
    gr[d] = 0.f;
    acc[d] = 0.f;
  }
  if (active) {
    const T* qrow = q + a.sqkv.at(b, h, row);
    const T* grow = static_cast<const T*>(a.g) + a.sg.at(b, h, row);
#pragma unroll
    for (int d = 0; d < W; ++d) {
      if (col0 + d < s_dim) {
        qr[d] = round_to<T>(to_float(qrow[col0 + d]) * a.scale) * LOG2E;
        gr[d] = to_float(grow[col0 + d]);
      }
    }
    const float2 st = a.stats[(int64_t)bh * T_len + row];
    m = st.x;
    inv_l = 1.f / st.y;
#pragma unroll
    for (int d = 0; d < W; ++d) {
      if (col0 + d < s_dim) c0 = fmaf(gr[d], to_float(vb[col0 + d]), c0);  // dP of key 0
    }
  }
  c0 = row_sum<SP::N>(c0);

  // pass 0: D = rowsum(P o dP), summed as c0 + rowsum(P o (dP - c0)); pass
  // 1: dS and dq. A masked key adds nothing: P is 0 there unless the whole row
  // is masked, whose dS is 0 anyway.
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) D += c0;
    for (int j0 = 0; j0 < T_len; j0 += BK) {
      __syncthreads();  // the previous tile has been consumed
      for (int idx = threadIdx.x; idx < BK * S; idx += BQ) {
        const int j = idx / S;
        const int d = idx - j * S;
        const int key = j0 + j;
        float kv = 0.f, vv = 0.f;
        if (key < T_len && d < s_dim) {
          kv = round_to<T>(to_float(kb[key * a.sqkv.t + d]) * a.scale);
          vv = to_float(vb[key * a.sqkv.t + d]);
        }
        ks[j][d] = kv;
        vs[j][d] = vv;
      }
      if (threadIdx.x < BK) {
        const int key = j0 + threadIdx.x;
        kind[threadIdx.x] = key >= T_len ? 2
            : (a.mask != nullptr && !a.mask[(int64_t)b * T_len + key]) ? 1 : 0;
      }
      __syncthreads();

#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        // dS is zero at a masked key and there is no key past T: the branch is
        // uniform across the block (kind is per key).
        if (kind[j] != 0) continue;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < W; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&ks[j][col0 + d]);
          const float4 vv = *reinterpret_cast<const float4*>(&vs[j][col0 + d]);
          s = fmaf(qr[d], kk.x, s);
          s = fmaf(qr[d + 1], kk.y, s);
          s = fmaf(qr[d + 2], kk.z, s);
          s = fmaf(qr[d + 3], kk.w, s);
          dp = fmaf(gr[d], vv.x, dp);
          dp = fmaf(gr[d + 1], vv.y, dp);
          dp = fmaf(gr[d + 2], vv.z, dp);
          dp = fmaf(gr[d + 3], vv.w, dp);
        }
        s = row_sum<SP::N>(s);
        dp = row_sum<SP::N>(dp);
        const float p = exp2f(s - m) * inv_l;
        if (pass == 0) {
          D = fmaf(p, dp - c0, D);
          continue;
        }
        const float ds = round_to<T>(p * (dp - D));
#pragma unroll
        for (int d = 0; d < W; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&ks[j][col0 + d]);
          acc[d] = fmaf(ds, kk.x, acc[d]);
          acc[d + 1] = fmaf(ds, kk.y, acc[d + 1]);
          acc[d + 2] = fmaf(ds, kk.z, acc[d + 2]);
          acc[d + 3] = fmaf(ds, kk.w, acc[d + 3]);
        }
      }
    }
  }

  if (active) {
    if (col0 == 0) a.dsum[(int64_t)bh * T_len + row] = D;
    T* o = static_cast<T*>(a.dq) + a.sgrad.at(b, h, row);
#pragma unroll
    for (int d = 0; d < W; ++d) {
      if (col0 + d < s_dim) o[col0 + d] = from_float<T>(acc[d] * a.scale);
    }
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(BKV) flash_attention_bwd_dkdv_kernel(const Args a) {
  static_assert(S % 4 == 0, "head dim capacity must be a multiple of 4");
  using SP = Split<S>;
  constexpr int W = SP::W;
  __shared__ __align__(16) float qs[BQT][S];
  __shared__ __align__(16) float gs[BQT][S];
  __shared__ float row_m[BQT], row_inv_l[BQT], row_d[BQT];

  const int T_len = a.T_len, s_dim = a.S;
  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int key = blockIdx.y * (BKV / SP::N) + threadIdx.x / SP::N;
  const int col0 = (threadIdx.x % SP::N) * W;  // this thread's first column
  const bool active = key < T_len;
  // A masked key (or one past T) keeps the fill score: P there is 0 unless the
  // whole row is masked, where it is 1/T like every other key of the row.
  const bool valid = active && (a.mask == nullptr || a.mask[(int64_t)b * T_len + key]);
  const T* qb = static_cast<const T*>(a.q) + a.sqkv.at(b, h, 0);
  const T* gb = static_cast<const T*>(a.g) + a.sg.at(b, h, 0);

  float kr[W], vr[W], dk[W], dv[W];
#pragma unroll
  for (int d = 0; d < W; ++d) {
    kr[d] = 0.f;
    vr[d] = 0.f;
    dk[d] = 0.f;
    dv[d] = 0.f;
  }
  if (active) {
    const T* krow = static_cast<const T*>(a.k) + a.sqkv.at(b, h, key);
    const T* vrow = static_cast<const T*>(a.v) + a.sqkv.at(b, h, key);
#pragma unroll
    for (int d = 0; d < W; ++d) {
      if (col0 + d < s_dim) {
        kr[d] = round_to<T>(to_float(krow[col0 + d]) * a.scale) * LOG2E;
        vr[d] = to_float(vrow[col0 + d]);
      }
    }
  }

  for (int i0 = 0; i0 < T_len; i0 += BQT) {
    __syncthreads();  // the previous tile has been consumed
    for (int idx = threadIdx.x; idx < BQT * S; idx += BKV) {
      const int i = idx / S;
      const int d = idx - i * S;
      const int row = i0 + i;
      float qv = 0.f, gv = 0.f;
      if (row < T_len && d < s_dim) {
        qv = round_to<T>(to_float(qb[row * a.sqkv.t + d]) * a.scale);
        gv = to_float(gb[row * a.sg.t + d]);
      }
      qs[i][d] = qv;
      gs[i][d] = gv;
    }
    if (threadIdx.x < BQT) {
      const int row = i0 + threadIdx.x;
      float rm = 0.f, ril = 0.f, rd = 0.f;  // rows past T: p = 0 (qs is 0 there)
      if (row < T_len) {
        const float2 st = a.stats[(int64_t)bh * T_len + row];
        rm = st.x;
        ril = 1.f / st.y;
        rd = a.dsum[(int64_t)bh * T_len + row];
      }
      row_m[threadIdx.x] = rm;
      row_inv_l[threadIdx.x] = ril;
      row_d[threadIdx.x] = rd;
    }
    __syncthreads();

#pragma unroll 4
    for (int i = 0; i < BQT; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < W; d += 4) {
        const float4 qq = *reinterpret_cast<const float4*>(&qs[i][col0 + d]);
        const float4 gg = *reinterpret_cast<const float4*>(&gs[i][col0 + d]);
        s = fmaf(kr[d], qq.x, s);
        s = fmaf(kr[d + 1], qq.y, s);
        s = fmaf(kr[d + 2], qq.z, s);
        s = fmaf(kr[d + 3], qq.w, s);
        dp = fmaf(vr[d], gg.x, dp);
        dp = fmaf(vr[d + 1], gg.y, dp);
        dp = fmaf(vr[d + 2], gg.z, dp);
        dp = fmaf(vr[d + 3], gg.w, dp);
      }
      s = row_sum<SP::N>(s);
      dp = row_sum<SP::N>(dp);
      if (!valid) s = MASK_FILL_LOG2;
      const float p = exp2f(s - row_m[i]) * row_inv_l[i];
      const float pr = round_to<T>(p);
#pragma unroll
      for (int d = 0; d < W; d += 4) {
        const float4 gg = *reinterpret_cast<const float4*>(&gs[i][col0 + d]);
        dv[d] = fmaf(pr, gg.x, dv[d]);
        dv[d + 1] = fmaf(pr, gg.y, dv[d + 1]);
        dv[d + 2] = fmaf(pr, gg.z, dv[d + 2]);
        dv[d + 3] = fmaf(pr, gg.w, dv[d + 3]);
      }
      if (valid) {  // dS is zero at a masked key
        const float ds = round_to<T>(p * (dp - row_d[i]));
#pragma unroll
        for (int d = 0; d < W; d += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(&qs[i][col0 + d]);
          dk[d] = fmaf(ds, qq.x, dk[d]);
          dk[d + 1] = fmaf(ds, qq.y, dk[d + 1]);
          dk[d + 2] = fmaf(ds, qq.z, dk[d + 2]);
          dk[d + 3] = fmaf(ds, qq.w, dk[d + 3]);
        }
      }
    }
  }

  if (active) {
    const int64_t off = a.sgrad.at(b, h, key);
    T* dko = static_cast<T*>(a.dk) + off;
    T* dvo = static_cast<T*>(a.dv) + off;
#pragma unroll
    for (int d = 0; d < W; ++d) {
      if (col0 + d < s_dim) {
        dko[col0 + d] = from_float<T>(dk[d] * a.scale);
        dvo[col0 + d] = from_float<T>(dv[d]);
      }
    }
  }
}

template <typename T, int S>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int N = Split<S>::N;
  const dim3 grid_q(B * a.H, (a.T_len + BQ / N - 1) / (BQ / N));
  flash_attention_bwd_dq_kernel<T, S><<<grid_q, BQ, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(B * a.H, (a.T_len + BKV / N - 1) / (BKV / N));
  flash_attention_bwd_dkdv_kernel<T, S><<<grid_kv, BKV, 0, stream>>>(a);
  return cudaGetLastError();
}

// The smallest capacity that holds the head dim a.S.
template <typename T>
cudaError_t dispatch_head_dim(const Args& a, int B, cudaStream_t stream) {
  if (a.S < 1) return cudaErrorInvalidValue;
  if (a.S <= 4) return launch<T, 4>(a, B, stream);
  if (a.S <= 8) return launch<T, 8>(a, B, stream);
  if (a.S <= 16) return launch<T, 16>(a, B, stream);
  if (a.S <= 32) return launch<T, 32>(a, B, stream);
  if (a.S <= 64) return launch<T, 64>(a, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; S is the head dim, 1 to 64. q, k, v
// share the (b, h, t) strides (sib, sih, sit); g and the gradients have their
// own; the S dim is contiguous in all. dq, dk and dv share (sdb, sdh, sdt). mask is (B, T) bytes,
// contiguous, or null for "all valid"; stats is the forward's (B*H*T, 2)
// float32 residual; dsum is a (B*H*T) float32 scratch.
extern "C" int mmsn_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* mask,
    const void* stats, const void* g, void* dq, void* dk, void* dv, void* dsum,
    int B, int H, int T_len, int S, int dtype, float scale,
    int64_t sib, int64_t sih, int64_t sit, int64_t sgb, int64_t sgh, int64_t sgt,
    int64_t sdb, int64_t sdh, int64_t sdt, void* stream) {
  if (B < 1 || H < 1 || T_len < 1 || (int64_t)B * H > 0x7fffffff || stats == nullptr ||
      dsum == nullptr)
    return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = static_cast<const uint8_t*>(mask);
  a.stats = static_cast<const float2*>(stats);
  a.g = g;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dsum = static_cast<float*>(dsum);
  a.H = H;
  a.T_len = T_len;
  a.S = S;
  a.scale = scale;
  a.sqkv = Strides{sib, sih, sit};
  a.sg = Strides{sgb, sgh, sgt};
  a.sgrad = Strides{sdb, sdh, sdt};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_head_dim<float>(a, B, st);
    case 1:
      return dispatch_head_dim<__nv_bfloat16>(a, B, st);
    default:
      return cudaErrorInvalidValue;
  }
}
