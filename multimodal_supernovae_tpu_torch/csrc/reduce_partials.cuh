// The second pass of every backward kernel's parameter gradients
// (csrc/fused_ffn_bwd.cu, csrc/fused_ffn_bwd_mma.cu, csrc/fused_qkv_bwd.cu,
// csrc/fused_qkv_bwd_mma.cu): blocks of the first pass each write a float32
// partial of their own, and this kernel sums them in block order. The result
// does not depend on the schedule: deterministic, no atomics. Stacked members
// (a member axis, one launch for all of them) are grid.y: member m sums its own
// blocks' partials into its own gradient row, as a call for m alone would.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace partials {

// grads[m][p] = sum over blocks b, in order, of partial[m][b][p], for p < P and
// member m = blockIdx.y; member m's partials start at partial + m * partial_stride
// and its gradients at grads + m * grads_stride.
__global__ void reduce_partials(const float* __restrict__ partial, int blocks, int P,
                                int64_t partial_stride, float* __restrict__ grads,
                                int64_t grads_stride) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  partial += blockIdx.y * partial_stride;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[(int64_t)b * P + p];
  grads[blockIdx.y * grads_stride + p] = s;
}

// Launches reduce_partials on the stream for M members; returns
// cudaGetLastError(). One member (M = 1) ignores both strides.
inline cudaError_t reduce(const float* partial, int blocks, int P, float* grads,
                          cudaStream_t stream, int M = 1, int64_t partial_stride = 0,
                          int64_t grads_stride = 0) {
  reduce_partials<<<dim3((P + 255) / 256, M), 256, 0, stream>>>(partial, blocks, P,
                                                                 partial_stride, grads,
                                                                 grads_stride);
  return cudaGetLastError();
}

// p + m * size, member m = blockIdx.y's slice of a stacked (M, size) tensor,
// for the first passes. m is read anew at each call (a volatile read the
// compiler neither hoists nor merges), so each member pointer is formed where
// it is used and lives no longer: held through a kernel, a dozen of them cost
// the CUDA-core fused-block backward its spill-free registers.
template <typename T>
__device__ __forceinline__ T* member_slice(T* p, int64_t size) {
  unsigned m;
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(m));
  return p + m * size;
}

}  // namespace partials
