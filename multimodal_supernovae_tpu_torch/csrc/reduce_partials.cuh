// The second pass of every backward kernel's parameter gradients
// (csrc/fused_ffn_bwd.cu, csrc/fused_ffn_bwd_mma.cu, csrc/fused_qkv_bwd.cu,
// csrc/fused_qkv_bwd_mma.cu): blocks of the first pass each write a float32
// partial of their own, and this kernel sums them in block order. The result
// does not depend on the schedule: deterministic, no atomics.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace partials {

// grads[p] = sum over blocks b, in order, of partial[b][p], for p < P.
__global__ void reduce_partials(const float* __restrict__ partial, int blocks, int P,
                                float* __restrict__ grads) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[(int64_t)b * P + p];
  grads[p] = s;
}

// Launches reduce_partials on the stream; returns cudaGetLastError().
inline cudaError_t reduce(const float* partial, int blocks, int P, float* grads,
                          cudaStream_t stream) {
  reduce_partials<<<(P + 255) / 256, 256, 0, stream>>>(partial, blocks, P, grads);
  return cudaGetLastError();
}

}  // namespace partials
