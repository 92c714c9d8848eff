// The epilogues of the bf16 matrix products, in the Pallas rounding order,
// all in fp32 until the one rounding. gemm_fwd.cu (gemm_bias_act): + bias;
// the pre-activation kept in fp32 if asked; the activation; one bf16
// rounding, after which a residual is added in bf16 (computed in fp32,
// rounded). gemm_dgrad.cu: times act'(preact) (the MLP's activation grad);
// then either an fp32 store or one bf16 rounding. The i8 product
// (gemm_i8.cu) shares the activation.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace gemm_epi {

enum Act : int { kNone = 0, kQuickGelu = 1, kGelu = 2 };

__device__ __forceinline__ float act_fwd(float v, int act) {
  if (act == kQuickGelu) return v * (1.f / (1.f + expf(-1.702f * v)));
  if (act == kGelu) return v * (erff(v * 0.70710678118654752f) + 1.f) * 0.5f;
  return v;
}

// d act(a) / d a: the JAX package's `_act_vjp`
__device__ __forceinline__ float act_grad(float a, int act) {
  if (act == kQuickGelu) {
    const float sig = 1.f / (1.f + expf(-1.702f * a));
    return sig * (1.f + 1.702f * a * (1.f - sig));
  }
  if (act == kGelu) {
    const float phi = expf(-0.5f * a * a) * 0.39894228040143268f;
    return 0.5f * (1.f + erff(a * 0.70710678118654752f)) + a * phi;
  }
  return 1.f;
}

// gemm_bias_act's epilogue
struct Epilogue {
  const float* bias;              // [N] or null
  int act;                        // activation applied last
  float* preact;                  // [M, N] fp32 copy of (sum + bias) or null
  __nv_bfloat16* out_bf16;        // [M, N] bf16 result
  const __nv_bfloat16* residual;  // added after the bf16 rounding, or null
};

// the whole epilogue for the fp32 sum v of element o = row * N + column gn
__device__ __forceinline__ void epilogue_at(const Epilogue& ep, float v, size_t o, int gn) {
  if (ep.bias != nullptr) v = __fadd_rn(v, ep.bias[gn]);
  if (ep.preact != nullptr) ep.preact[o] = v;
  v = act_fwd(v, ep.act);
  __nv_bfloat16 y = __float2bfloat16(v);
  if (ep.residual != nullptr)
    y = __float2bfloat16(__bfloat162float(ep.residual[o]) + __bfloat162float(y));
  ep.out_bf16[o] = y;
}

// the same for two neighbouring columns (o even, N even) whose bias b and
// residual r the caller loaded before (r unused without a residual), with a
// paired store. kAct is ep.act, fixed at compile time so only its
// activation is compiled in.
template <int kAct>
__device__ __forceinline__ void epilogue_pair(const Epilogue& ep, float v0, float v1, float2 b,
                                              __nv_bfloat162 r, size_t o) {
  v0 = __fadd_rn(v0, b.x);
  v1 = __fadd_rn(v1, b.y);
  if (ep.preact != nullptr) *reinterpret_cast<float2*>(ep.preact + o) = make_float2(v0, v1);
  __nv_bfloat162 y = __floats2bfloat162_rn(act_fwd(v0, kAct), act_fwd(v1, kAct));
  if (ep.residual != nullptr)
    y = __floats2bfloat162_rn(__bfloat162float(r.x) + __bfloat162float(y.x),
                              __bfloat162float(r.y) + __bfloat162float(y.y));
  *reinterpret_cast<__nv_bfloat162*>(ep.out_bf16 + o) = y;
}

// gemm_dgrad's epilogue for two neighbouring columns (o even, N even): the
// sums times act'(a) of their fp32 pre-activations a, which the caller
// loaded before (unused for kAct = kNone), then a paired fp32 store
// (out_f32 not null) or one bf16 rounding.
template <int kAct>
__device__ __forceinline__ void act_grad_pair(float v0, float v1, float2 a, float* out_f32,
                                              __nv_bfloat16* out_bf16, size_t o) {
  if (kAct != kNone) {
    v0 = v0 * act_grad(a.x, kAct);
    v1 = v1 * act_grad(a.y, kAct);
  }
  if (out_f32 != nullptr)
    *reinterpret_cast<float2*>(out_f32 + o) = make_float2(v0, v1);
  else
    *reinterpret_cast<__nv_bfloat162*>(out_bf16 + o) = __floats2bfloat162_rn(v0, v1);
}

}  // namespace gemm_epi
