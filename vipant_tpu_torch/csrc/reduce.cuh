// The second, deterministic stage of the column reductions (colsum in
// reduce.cu, the LayerNorm weight and bias grads in layernorm.cu): their
// first stage writes one partial row per block of input rows, and this sums
// those partial rows in order, one thread per column. Each translation
// unit that includes this gets its own copy (anonymous namespace).

#pragma once

#include <cuda_runtime.h>

namespace {
namespace reduce {

__global__ void sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                    int chunks, int cols) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[static_cast<size_t>(c) * cols + col];
  out[col] = s;
}

inline cudaError_t sum_partials(const float* partial, float* out, int chunks, int cols,
                                cudaStream_t stream) {
  sum_partials_kernel<<<(cols + 255) / 256, 256, 0, stream>>>(partial, out, chunks, cols);
  return cudaGetLastError();
}

}  // namespace reduce
}  // namespace
