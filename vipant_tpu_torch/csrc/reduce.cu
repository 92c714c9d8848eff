// colsum: fp32 sums over the rows of a [rows, N] bf16 or fp32 matrix -- the
// bias grads of the backward chains (dbout, dbqkv, dbproj, dbfc).
//
// Replaces: the `jnp.sum(..., axis=0)` bias-grad accumulations inside the
// Pallas kernels vipant_tpu/ops/fused_attn.py::_bwd_kernel (dbout, line 217;
// dbqkv, line 229) and vipant_tpu/ops/fused_mlp.py::_bwd_kernel (dbproj,
// line 78; dbfc, line 82), which the TPU summed over its sequential grid.
//
// Bound: memory; one read of the matrix. Blocks run in parallel and in no
// order on Hopper, so the sum is two deterministic stages with no atomics:
// a block of 32 x 8 threads sums `rows_per_block` rows of 32 columns (a warp
// reads 32 neighbouring columns of one row) into one partial row, and
// reduce.cuh sums the partial rows in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace {

constexpr int kCols = 32, kLanes = 8;

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kCols * kLanes)
colsum_partial_kernel(const T* __restrict__ x, float* __restrict__ partial, long long rows, int N,
                      int rows_per_block) {
  __shared__ float red[kLanes][kCols + 1];
  const int col = blockIdx.x * kCols + threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  float s = 0.f;
  if (col < N)
    for (long long r = r0 + threadIdx.y; r < r1; r += kLanes) s += as_float(x[r * N + col]);
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < N) {
    float t = 0.f;
    for (int k = 0; k < kLanes; ++k) t += red[k][threadIdx.x];
    partial[static_cast<size_t>(blockIdx.y) * N + col] = t;
  }
}

}  // namespace

// partial: [ceil(rows / rows_per_block), N] fp32 scratch; out: [N] fp32
extern "C" int vt_colsum(const void* x, int is_f32, void* partial, void* out, long long rows,
                         int N, int rows_per_block, void* stream) {
  if (N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = static_cast<int>((rows + rows_per_block - 1) / rows_per_block);
  if (chunks > 0) {
    const dim3 grid((N + kCols - 1) / kCols, chunks), block(kCols, kLanes);
    if (is_f32)
      colsum_partial_kernel<<<grid, block, 0, s>>>(static_cast<const float*>(x),
                                                   static_cast<float*>(partial), rows, N,
                                                   rows_per_block);
    else
      colsum_partial_kernel<<<grid, block, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                   static_cast<float*>(partial), rows, N,
                                                   rows_per_block);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(reduce::sum_partials(static_cast<const float*>(partial),
                                               static_cast<float*>(out), chunks, N, s));
}
