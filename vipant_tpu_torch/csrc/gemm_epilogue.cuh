// The epilogue of the bf16 matrix products (gemm_fwd.cu: gemm_bias_act;
// gemm.cu: gemm_dgrad), in the Pallas rounding order, all in fp32 until the
// one rounding: + bias; the pre-activation kept in fp32 if asked; times
// act'(preact) (the MLP's activation grad); the activation; then either an
// fp32 store or one bf16 rounding, after which a residual is added in bf16
// (computed in fp32, rounded).

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

struct Epilogue {
  const float* bias;              // [N] or null
  const float* grad_preact;       // [M, N] fp32: multiply by act_grad(.) (dgrad) or null
  int grad_act;
  int act;                        // activation applied last
  float* preact;                  // [M, N] fp32 copy of (sum + bias) or null
  float* out_f32;                 // [M, N] fp32 result or null
  __nv_bfloat16* out_bf16;        // [M, N] bf16 result or null
  const __nv_bfloat16* residual;  // added after the bf16 rounding, or null
};

// the whole epilogue for the fp32 sum v of element o = row * N + column gn
__device__ __forceinline__ void epilogue_at(const Epilogue& ep, float v, size_t o, int gn) {
  if (ep.bias != nullptr) v = __fadd_rn(v, ep.bias[gn]);
  if (ep.preact != nullptr) ep.preact[o] = v;
  if (ep.grad_preact != nullptr) v = v * act_grad(ep.grad_preact[o], ep.grad_act);
  v = act_fwd(v, ep.act);
  if (ep.out_f32 != nullptr) ep.out_f32[o] = v;
  if (ep.out_bf16 != nullptr) {
    __nv_bfloat16 y = __float2bfloat16(v);
    if (ep.residual != nullptr)
      y = __float2bfloat16(__bfloat162float(ep.residual[o]) + __bfloat162float(y));
    ep.out_bf16[o] = y;
  }
}

// the same for two neighbouring columns (o even, N even) whose bias b and
// residual r the caller loaded before (r unused without a residual), with a
// paired store; no activation grad (the forward's epilogue). kAct is
// ep.act, fixed at compile time so only its activation is compiled in.
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

}  // namespace gemm_epi
