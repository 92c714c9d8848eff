// layernorm_fwd: the LayerNorm prologue of both fused transformer sub-blocks.
//
// Replaces: the `_ln_fwd` step inside the Pallas kernels
//   vipant_tpu/ops/fused_attn.py::_fwd_kernel (line 98) and
//   vipant_tpu/ops/fused_mlp.py::_fwd_kernel (line 53).
// On the TPU the normalised rows never left VMEM; here they make one bf16
// round trip through device memory, because the product that follows is a
// separate kernel (gemm.cu).
//
// Bound: memory. One row of C bf16 values is read twice (from L1/L2 the
// second time) and written once; at the slice's shapes (C = 512 or 768) the
// arithmetic is a few operations per byte.
//
// Design: one block per row, 256 threads; each thread strides over the row.
// Statistics are fp32 and two-pass (mean, then the mean of squared
// deviations), eps is added before rsqrt, and the affine result is rounded
// to bf16 once -- the rounding order of `_ln_fwd`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (kThreads >> 5) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  const float total = red[0];
  __syncthreads();  // `red` is reused by the next reduction
  return total;
}

__global__ void __launch_bounds__(kThreads)
layernorm_fwd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, __nv_bfloat16* __restrict__ y, int C,
                     float eps) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * C;
  __nv_bfloat16* yr = y + row * C;

  float s = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) s += __bfloat162float(xr[c]);
  const float mu = block_sum(s, red) / static_cast<float>(C);

  float v = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float d = __bfloat162float(xr[c]) - mu;
    v += d * d;
  }
  const float var = block_sum(v, red) / static_cast<float>(C);
  const float rstd = rsqrtf(var + eps);

  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float xhat = __fmul_rn(__bfloat162float(xr[c]) - mu, rstd);
    yr[c] = __float2bfloat16(__fadd_rn(__fmul_rn(xhat, w[c]), b[c]));
  }
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

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
