// layernorm_fwd / layernorm_bwd: the LayerNorm prologue of both fused
// transformer sub-blocks, and its backward with the residual grad.
//
// Replaces: the `_ln_fwd` step inside the Pallas kernels
//   vipant_tpu/ops/fused_attn.py::_fwd_kernel (line 98) and
//   vipant_tpu/ops/fused_mlp.py::_fwd_kernel (line 53), and the LayerNorm
// backward of their backward kernels
//   vipant_tpu/ops/fused_attn.py::_bwd_kernel (lines 234-247) and
//   vipant_tpu/ops/fused_mlp.py::_bwd_kernel (lines 86-94).
// On the TPU the normalised rows never left VMEM and the weight and bias
// grads were summed over the sequential grid; here the normalised rows make
// one bf16 round trip through device memory, because the product that
// follows is a separate kernel (gemm_fwd.cu), and the grads are summed in two
// deterministic stages.
//
// Bound: memory. The forward reads a row of C bf16 values twice (from L1/L2
// the second time) and writes it once; the backward reads x, the fp32 dh and
// the residual grad, and writes dx. At C = 512 or 768 the arithmetic is a
// few operations per byte.
//
// Design: forward, one block per row, 256 threads striding over it.
// Statistics are fp32 and two-pass (mean, then the mean of squared
// deviations), eps is added before rsqrt, and the affine result is rounded
// to bf16 once -- the rounding order of `_ln_fwd`. Backward, one block per
// `rows_per_block` rows: for each row it recomputes the statistics with the
// forward's code (so xhat is bitwise the forward's), forms
// dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) with
// dxhat = dh * w, adds the residual grad in fp32 and rounds once; each
// thread keeps its columns' running sums of dh * xhat and dh in shared
// memory, written as the block's partial row, which reduce.cuh sums. The row
// statistics and block reductions are rows.cuh's, shared with quant.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "reduce.cuh"
#include "rows.cuh"

namespace {

using rows::block_sum;
using rows::kThreads;
using rows::ln_affine;
using rows::ln_xhat;
using rows::row_stats;

__global__ void __launch_bounds__(kThreads)
layernorm_fwd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, __nv_bfloat16* __restrict__ y, int C,
                     float eps) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * C;
  __nv_bfloat16* yr = y + row * C;
  const float2 st = row_stats(xr, C, eps, red);
  for (int c = threadIdx.x; c < C; c += kThreads) {
    yr[c] = ln_affine(xr[c], st, w[c], b[c]);
  }
}

__global__ void __launch_bounds__(kThreads)
layernorm_bwd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ dh, const __nv_bfloat16* __restrict__ res,
                     __nv_bfloat16* __restrict__ dx, float* __restrict__ partial, long long rows,
                     int C, int rows_per_block, float eps) {
  extern __shared__ float sums[];  // [2C]: this block's sums of dh * xhat, then of dh
  __shared__ float red[32];
  for (int c = threadIdx.x; c < 2 * C; c += kThreads) sums[c] = 0.f;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  for (long long row = r0; row < r1; ++row) {
    const __nv_bfloat16* xr = x + row * C;
    const float* dhr = dh + row * C;
    const float2 st = row_stats(xr, C, eps, red);
    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const float xhat = ln_xhat(xr[c], st);
      const float g = dhr[c];
      const float dxhat = g * w[c];
      sums[c] += g * xhat;
      sums[C + c] += g;
      s1 += dxhat;
      s2 += dxhat * xhat;
    }
    const float m1 = block_sum(s1, red) / static_cast<float>(C);
    const float m2 = block_sum(s2, red) / static_cast<float>(C);
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const float xhat = ln_xhat(xr[c], st);
      float v = st.y * (dhr[c] * w[c] - m1 - xhat * m2);
      if (res != nullptr) v += __bfloat162float(res[row * C + c]);
      dx[row * C + c] = __float2bfloat16(v);
    }
  }
  // the block_sum barriers of the last row ordered every write of `sums`
  for (int c = threadIdx.x; c < 2 * C; c += kThreads)
    partial[static_cast<size_t>(blockIdx.x) * 2 * C + c] = sums[c];
}

}  // namespace

extern "C" int vt_layernorm_fwd(const void* x, const void* w, const void* b, void* y,
                                long long rows, int C, float eps, void* stream) {
  if (rows <= 0) return 0;
  layernorm_fwd_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y), C, eps);
  return static_cast<int>(cudaGetLastError());
}

// dx [rows, C] bf16; partial: [ceil(rows / rows_per_block), 2C] fp32
// scratch; dwb: [2C] fp32 receiving the weight grad, then the bias grad
extern "C" int vt_layernorm_bwd(const void* x, const void* w, const void* dh, const void* res,
                                void* dx, void* partial, void* dwb, long long rows, int C,
                                int rows_per_block, float eps, void* stream) {
  if (C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = static_cast<int>((rows + rows_per_block - 1) / rows_per_block);
  const int smem = 2 * C * static_cast<int>(sizeof(float));
  if (chunks > 0) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          layernorm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    layernorm_bwd_kernel<<<chunks, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<const float*>(dh), static_cast<const __nv_bfloat16*>(res),
        static_cast<__nv_bfloat16*>(dx), static_cast<float*>(partial), rows, C, rows_per_block,
        eps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(reduce::sum_partials(static_cast<const float*>(partial),
                                               static_cast<float*>(dwb), chunks, 2 * C, s));
}

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
