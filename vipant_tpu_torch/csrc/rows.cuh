// Row-wise helpers shared by layernorm.cu and quant.cu: block reductions and
// the fp32 LayerNorm statistics of one row. A block of `kThreads` threads
// owns one row at a time and strides over its columns.
//
// Both files normalise a row with the same `row_stats` and `ln_affine`, so
// the LayerNorm fused into the int8 quantization (quant.cu) is bitwise the
// stand-alone layernorm_fwd.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace rows {

constexpr int kThreads = 256;

// Sum (kMax = false) or maximum (kMax = true) of `v` over the block; `red`
// is 32 floats of shared memory, free again when the call returns.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, u) : v + u;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (kThreads >> 5) ? red[lane] : (kMax ? -INFINITY : 0.f);
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, t, o);
      t = kMax ? fmaxf(t, u) : t + u;
    }
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  const float total = red[0];
  __syncthreads();  // `red` is reused by the next reduction
  return total;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  return block_reduce<false>(v, red);
}

__device__ __forceinline__ float block_max(float v, float* red) {
  return block_reduce<true>(v, red);
}

// mean and rstd of one row, fp32, two-pass
__device__ __forceinline__ float2 row_stats(const __nv_bfloat16* xr, int C, float eps, float* red) {
  float s = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) s += __bfloat162float(xr[c]);
  const float mu = block_sum(s, red) / static_cast<float>(C);
  float v = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float d = __bfloat162float(xr[c]) - mu;
    v += d * d;
  }
  const float var = block_sum(v, red) / static_cast<float>(C);
  return make_float2(mu, rsqrtf(var + eps));
}

// the normalised value of one element: xhat, and xhat * w + b rounded to bf16
__device__ __forceinline__ float ln_xhat(__nv_bfloat16 x, float2 st) {
  return __fmul_rn(__bfloat162float(x) - st.x, st.y);
}

__device__ __forceinline__ __nv_bfloat16 ln_affine(__nv_bfloat16 x, float2 st, float w, float b) {
  return __float2bfloat16(__fadd_rn(__fmul_rn(ln_xhat(x, st), w), b));
}

}  // namespace rows
