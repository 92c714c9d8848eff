// Row-wise helpers shared by layernorm.cu and quant.cu, whose kernels give
// each row one warp that holds it in registers: the LayerNorm statistics of
// the row (taken in float64, rounded once to fp32), the normalised value of
// one element, the row's maximum magnitude, and the grid a persistent kernel
// launches.
//
// A row of C bf16 values (C % 8 == 0, C <= kMaxC, its start 16-byte aligned)
// is read as C / 8 vectors of 16 bytes: lane l of a warp takes vectors l,
// l + 32, l + 64, ... (`load_row`). `warp_row_stats` sums each lane's values
// in that order (vector by vector, element by element), from the registers
// of every caller (layernorm_fwd, layernorm_bwd, layernorm_rowquant), then
// combines the lanes with an xor-shuffle butterfly. Each step of the
// butterfly adds the same two values on both lanes of a pair (a + b == b + a
// in IEEE arithmetic), so all 32 lanes end with the same bits, and so does
// every warp of every kernel that calls it on the same row: layernorm_bwd's
// xhat is the forward's, and layernorm_rowquant is bitwise
// rowquant(layernorm_fwd(x)). The sums run in float64: the sum of a row of
// bf16 values is then exact in any order (while its values span less than
// 2^34 in magnitude), so the fp32 mean is the plain version's
// (kernels._ln_stats) bit for bit, and the sums of squares of two orders
// differ by float64 ulps, which the rounding of rstd to fp32 hides unless
// they straddle one of its boundaries. Without that, a one-ulp difference of
// an fp32 statistic can round a normalised value to the neighbouring bf16,
// and where that value is its row's largest, move the row's int8 scale and
// most of its codes. The arithmetic is written with the `__f*_rn` and
// `__d*_rn` intrinsics so no inlining context can contract it differently.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace rows {

constexpr int kMaxC = 2048;    // the widest row: 8 vectors of 16 bytes a lane of a warp

// the 8 bf16 values of a 16-byte vector as fp32 (exact), in memory order
__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(u[k] << 16);
    f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}

// two bf16 as the 32 bits that hold them in memory, `lo` first
__device__ __forceinline__ unsigned pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
}

// this lane's share of the row `xr`: vectors lane + 32 i, i < kVecs; those
// past the row (or all, if `valid` is false) are zero and never read
template <int kVecs>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ xr, int C, int lane,
                                         bool valid, uint4 (&v)[kVecs]) {
  const uint4* p = reinterpret_cast<const uint4*>(xr);
  const int nv = C >> 3;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int j = lane + 32 * i;
    v[i] = valid && j < nv ? p[j] : make_uint4(0u, 0u, 0u, 0u);
  }
}

// w and b of this lane's columns 8 j + k, j = lane + 32 i (zero past the
// row), read as float4 once per warp and kept across the rows it walks
template <int kVecs>
__device__ __forceinline__ void load_affine(const float* __restrict__ w, const float* __restrict__ b,
                                            int C, int lane, float (&wl)[kVecs][8],
                                            float (&bl)[kVecs][8]) {
  const int nv = C >> 3;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int j = lane + 32 * i;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* w4 = reinterpret_cast<const float4*>(w) + 2 * j;
    const float4* b4 = reinterpret_cast<const float4*>(b) + 2 * j;
    const float4 w0 = j < nv ? w4[0] : z, w1 = j < nv ? w4[1] : z;
    const float4 b0 = j < nv ? b4[0] : z, b1 = j < nv ? b4[1] : z;
    const float wa[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const float ba[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) wl[i][k] = wa[k], bl[i][k] = ba[k];
  }
}

// the largest of the warp's 32 values, in every lane (exact in any order)
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// s plus the 8 values of the vector v, in order, in float64
__device__ __forceinline__ double add_vec(double s, const uint4& v) {
  float f[8];
  unpack8(v, f);
#pragma unroll
  for (int k = 0; k < 8; ++k) s = __dadd_rn(s, static_cast<double>(f[k]));
  return s;
}

// q plus the squared deviations from mu of the 8 values of v, in order, in float64
// (each square rounded, then added: the plain version's (d * d).sum())
__device__ __forceinline__ double add_sqdev(double q, const uint4& v, double mu) {
  float f[8];
  unpack8(v, f);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const double d = __dsub_rn(static_cast<double>(f[k]), mu);
    q = __dadd_rn(q, __dmul_rn(d, d));
  }
  return q;
}

// the fp32 mean of a row from the lanes' float64 sums; rstd = 1 / sqrt(var + eps), correctly
// rounded in float64 and then to fp32, from the lanes' sums of squared deviations
__device__ __forceinline__ float row_mean(double s, int C) {
  return __double2float_rn(__ddiv_rn(warp_sum(s), static_cast<double>(C)));
}

__device__ __forceinline__ float row_rstd(double q, int C, float eps) {
  const double var = __ddiv_rn(warp_sum(q), static_cast<double>(C));
  return __double2float_rn(__drcp_rn(__dsqrt_rn(__dadd_rn(var, static_cast<double>(eps)))));
}

// (mean, rstd) of the row this warp holds in `v` (load_row), two-pass: the
// mean, then the mean of squared deviations from the fp32 mean; eps is
// added before the square root (the order of the Pallas kernels' `_ln_fwd`,
// whose sums are fp32). The same bits in every lane, for every kVecs that
// holds the row.
template <int kVecs>
__device__ __forceinline__ float2 warp_row_stats(const uint4 (&v)[kVecs], int C, int lane, float eps) {
  const int nv = C >> 3;
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < kVecs; ++i)
    if (lane + 32 * i < nv) s = add_vec(s, v[i]);
  const float mu = row_mean(s, C);
  double q = 0.0;
#pragma unroll
  for (int i = 0; i < kVecs; ++i)
    if (lane + 32 * i < nv) q = add_sqdev(q, v[i], static_cast<double>(mu));
  return make_float2(mu, row_rstd(q, C, eps));
}

// the normalised value of one element x (a bf16 value as fp32): xhat, and
// xhat * w + b rounded to bf16
__device__ __forceinline__ float ln_xhat(float x, float2 st) {
  return __fmul_rn(__fsub_rn(x, st.x), st.y);
}

__device__ __forceinline__ float ln_affine_f32(float x, float2 st, float w, float b) {
  return __fadd_rn(__fmul_rn(ln_xhat(x, st), w), b);
}

__device__ __forceinline__ __nv_bfloat16 ln_affine(float x, float2 st, float w, float b) {
  return __float2bfloat16(ln_affine_f32(x, st, w, b));
}

// blocks of `kernel` (`threads` a block, no dynamic shared memory) that the
// current device holds at once: its SMs times the blocks an SM takes; cached
// per device in `slots`, -1 on failure
template <typename Kernel>
inline int resident_blocks(int (&slots)[64], Kernel kernel, int threads) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  if (slots[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0) != cudaSuccess ||
        per_sm <= 0)
      return -1;
    slots[dev] = sms * per_sm;
  }
  return slots[dev];
}

}  // namespace rows
