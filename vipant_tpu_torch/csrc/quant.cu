// rowquant / layernorm_rowquant: per-row (per-token) symmetric int8
// quantization, alone and fused behind LayerNorm.
//
//   scale[r] = max_k |x[r, k]| / 127 + 1e-12              (fp32)
//   q[r, k]  = clip(round_half_even(x[r, k] / scale[r]), -127, 127)
//
// Replaces: the in-kernel activation quantizations of the Pallas int8 kernels
//   vipant_tpu/ops/fused_attn.py::_fwd_int8_kernel (of LN(x), lines 137-140;
//     of the fp32 attention context, lines 156-158) and
//   vipant_tpu/ops/fused_mlp.py::_fwd_int8_kernel (of LN(x), lines 110-111;
//     of the fp32 act(a), line 115),
// which are `quantize_rows` of vipant_tpu/ops/quant.py on VMEM-resident
// tiles. The same kernel quantizes the projection weights per output column
// (`quantize_cols` there): in the torch [out, in] layout an output column is
// a row.
//
// On the TPU the tensors to quantize never left VMEM. A per-token scale
// spans the whole row (all heads of the context, all 4C columns of the MLP
// activation), which no single tile of the product before it holds, so here
// the quantization is its own pass over rows that the producer wrote to
// device memory in the type the Pallas kernel quantized from (fp32 for the
// context and act(a)); only LayerNorm, whose block already owns whole rows,
// is fused with it.
//
// Bound: memory. One read of the row (4 or 2 bytes an element) and one
// 1-byte write; the second pass over the row hits L1/L2.
//
// Design: one block of 256 threads per row. Pass 1 takes the row's maximum
// magnitude, pass 2 divides (IEEE division, as the Pallas kernel divides:
// multiplying by a reciprocal flips codes), rounds half to even (`rintf`)
// and clips. layernorm_rowquant takes the LayerNorm statistics from
// rows.cuh's `warp_row_stats`, which every warp of the block computes on its
// own from the row (16-byte loads, shuffles only; the row comes from L1
// after the first warp's loads) with the same bits as layernorm_fwd's warp,
// forms the affine result with the same `ln_affine`, rounds it to bf16,
// keeps the row in shared memory as fp32 and quantizes from there, so the
// normalised row makes no trip through device memory and is bitwise
// rowquant(layernorm_fwd(x)). Its wrapper takes layernorm_fwd's contract
// (C % 8 == 0, C <= 2048, x 16-byte aligned).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "rows.cuh"

namespace {

using rows::block_max;
using rows::kThreads;

__device__ __forceinline__ float scale_of(float amax) {
  return __fadd_rn(__fdiv_rn(amax, 127.f), 1e-12f);
}

__device__ __forceinline__ signed char code_of(float v, float scale) {
  const float q = rintf(__fdiv_rn(v, scale));
  return static_cast<signed char>(fminf(fmaxf(q, -127.f), 127.f));
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
rowquant_kernel(const T* __restrict__ x, signed char* __restrict__ q, float* __restrict__ scale,
                int K) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * K;
  signed char* qr = q + row * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kThreads) amax = fmaxf(amax, fabsf(as_float(xr[k])));
  const float s = scale_of(block_max(amax, red));
  if (threadIdx.x == 0) scale[row] = s;
  for (int k = threadIdx.x; k < K; k += kThreads) qr[k] = code_of(as_float(xr[k]), s);
}

__global__ void __launch_bounds__(kThreads)
layernorm_rowquant_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ b, signed char* __restrict__ q,
                          float* __restrict__ scale, int C, float eps) {
  extern __shared__ float hrow[];  // [C]: LN(x) of this row, rounded to bf16, as fp32
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * C;
  signed char* qr = q + row * C;
  const float2 st = rows::warp_row_stats(xr, C, eps);
  float amax = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float h = __bfloat162float(rows::ln_affine(__bfloat162float(xr[c]), st, w[c], b[c]));
    hrow[c] = h;  // read back below by the same thread only
    amax = fmaxf(amax, fabsf(h));
  }
  const float s = scale_of(block_max(amax, red));
  if (threadIdx.x == 0) scale[row] = s;
  for (int c = threadIdx.x; c < C; c += kThreads) qr[c] = code_of(hrow[c], s);
}

}  // namespace

// q [rows, K] int8 and scale [rows] fp32 of x [rows, K], fp32 (is_f32) or bf16
extern "C" int vt_rowquant(const void* x, int is_f32, void* q, void* scale, long long rows_n,
                           int K, void* stream) {
  if (rows_n <= 0 || K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(rows_n);
  if (is_f32)
    rowquant_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<signed char*>(q), static_cast<float*>(scale), K);
  else
    rowquant_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<signed char*>(q),
        static_cast<float*>(scale), K);
  return static_cast<int>(cudaGetLastError());
}

// q [rows, C] int8 and scale [rows] fp32 of LayerNorm(x) rounded to bf16
extern "C" int vt_layernorm_rowquant(const void* x, const void* w, const void* b, void* q,
                                     void* scale, long long rows_n, int C, float eps,
                                     void* stream) {
  if (rows_n <= 0 || C <= 0) return 0;
  if (C % 8 != 0 || C > rows::kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = C * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        layernorm_rowquant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  layernorm_rowquant_kernel<<<static_cast<unsigned>(rows_n), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<signed char*>(q), static_cast<float*>(scale), C,
      eps);
  return static_cast<int>(cudaGetLastError());
}
