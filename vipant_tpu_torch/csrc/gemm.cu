// The matrix products of both fused sub-blocks, forward and data grads:
//
//   gemm_bias_act  Y = epilogue(X . W^T + b)     X [M, K], W [N, K]   (forward)
//   gemm_dgrad     Y = epilogue(dY . W)          dY [M, K], W [K, N]  (data grads)
//
// bf16 in, fp32 accumulate. Both are one templated kernel that differs only
// in which dimension of each operand is contiguous. The weight grads
// (A^T . B, a few output tiles and a long reduction) are gemm_wgrad.cu.
//
// Replaces: the matrix products inside the Pallas kernels
//   vipant_tpu/ops/fused_attn.py::_fwd_kernel (qkv projection, line 99;
//     out-projection + residual, lines 112-114),
//   vipant_tpu/ops/fused_attn.py::_bwd_kernel (do = g.Wout^T, line 218;
//     dh = dqkv.Wqkv^T, line 231),
//   vipant_tpu/ops/fused_mlp.py::_fwd_kernel (fc + activation, lines 54-55;
//     proj + residual, lines 56-57) and
//   vipant_tpu/ops/fused_mlp.py::_bwd_kernel (recomputed fc, line 74;
//     dg . act'(a), lines 80-81; dh, line 84).
// The TPU kernels held whole [T, 4C] intermediates in VMEM; a Hopper block
// has 227 KB of shared memory and blocks run in parallel, so each product is
// its own launch and the intermediates make one round trip through device
// memory.
//
// Bound: tensor-core operations at the slice's shapes (M = B*T in the
// thousands, N and K in 512..3072); this first version uses warp-level
// `nvcuda::wmma` 16x16x16 tiles, not Hopper's `wgmma`, so it reaches only a
// share of the card's bf16 peak.
//
// Design: a block computes a 128x128 tile of Y with 8 warps (2 x 4, 64x32
// each), walking the reduction in steps of 32 through a two-stage cp.async
// ring in shared memory. An operand stored reduction-contiguous ([rows, K])
// is staged as [128][32] and read as a row-major A / col-major B fragment;
// one stored row-contiguous ([K, rows]) is staged as [32][128] and read as a
// col-major A / row-major B fragment, so nothing is transposed in memory.
// Rows past M, columns past N and reduction steps past K are zero-filled on
// load and masked on store (M = B*T is ragged: T = 306, 308, 200).
//
// Epilogue, in the Pallas rounding order, all in fp32 until the one
// rounding: + bias; the pre-activation kept in fp32 if asked; times
// act'(preact) (the MLP's activation grad); the activation; then either an
// fp32 store or one bf16 rounding, after which a residual is added in bf16
// (computed in fp32, rounded).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include <type_traits>

#include "async_copy.cuh"

namespace {

using namespace nvcuda;
using namespace async_copy;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDK = BK + 8;    // [rows][BK] staging row: 80 bytes
constexpr int LDR = BM + 8;    // [BK][rows] staging row: 272 bytes
constexpr int kThreads = 256;
constexpr int WM = 64, WN = 32;            // warp tile
constexpr int FM = WM / 16, FN = WN / 16;  // 4 x 2 accumulator fragments per warp
constexpr int kStageElems = BM * LDK > BK * LDR ? BM * LDK : BK * LDR;

enum Act : int { kNone = 0, kQuickGelu = 1, kGelu = 2 };

// Stage one 128-row x BK slice of an operand, 16-byte chunks, two per
// thread. kRowsContig = false: the operand is [rows, K] with K contiguous
// (K % 8 == 0), staged [128][LDK]. kRowsContig = true: it is [K, rows] with
// rows contiguous (rows % 8 == 0), staged [BK][LDR]. Either way a chunk is
// wholly in or out of bounds.
template <bool kRowsContig>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int rows, int k0, int K) {
#pragma unroll
  for (int i = 0; i < (BM * BK / 8) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if constexpr (kRowsContig) {
      const int kr = c >> 4, rc = (c & 15) * 8;
      const int gk = k0 + kr, gr = row0 + rc;
      const bool in = gk < K && gr < rows;
      const __nv_bfloat16* g = in ? src + static_cast<size_t>(gk) * rows + gr : src;
      cp_async16(dst + kr * LDR + rc, g, in);
    } else {
      const int r = c >> 2, kc = (c & 3) * 8;
      const int gr = row0 + r, gk = k0 + kc;
      const bool in = gr < rows && gk < K;
      const __nv_bfloat16* g = in ? src + static_cast<size_t>(gr) * K + gk : src;
      cp_async16(dst + r * LDK + kc, g, in);
    }
  }
}

// address of the 16x16 fragment at (row r, reduction step kk) in a staged tile
template <bool kRowsContig>
__device__ __forceinline__ const __nv_bfloat16* frag_at(const __nv_bfloat16* tile, int r, int kk) {
  return kRowsContig ? tile + kk * LDR + r : tile + r * LDK + kk;
}

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

// A is [M, K] (kATrans = false) or [K, M] (true); B is [N, K] (kBTrans =
// false) or [K, N] (true).
template <bool kATrans, bool kBTrans>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B, int M,
            int N, int K, Epilogue ep) {
  __shared__ __align__(128) __nv_bfloat16 As[2][kStageElems];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][kStageElems];

  using LayoutA = std::conditional_t<kATrans, wmma::col_major, wmma::row_major>;
  using LayoutB = std::conditional_t<kBTrans, wmma::row_major, wmma::col_major>;

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (K + BK - 1) / BK;
  load_tile<kATrans>(As[0], A, m0, M, 0, K);
  load_tile<kBTrans>(Bs[0], B, n0, N, 0, K);
  cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) {
      load_tile<kATrans>(As[s ^ 1], A, m0, M, (kt + 1) * BK, K);
      load_tile<kBTrans>(Bs[s ^ 1], B, n0, N, (kt + 1) * BK, K);
    }
    cp_async_commit();  // possibly empty: keeps "all but the newest group" meaning tile kt
    cp_async_wait<1>();
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LayoutA> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayoutB> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], frag_at<kATrans>(As[s], wm * WM + i * 16, kk),
                               kATrans ? LDR : LDK);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], frag_at<kBTrans>(Bs[s], wn * WN + j * 16, kk),
                               kBTrans ? LDR : LDK);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // stage s is refilled by the next iteration's loads
  }

  // Epilogue through a per-warp 16x16 fp32 scratch carved from As (free now:
  // the last __syncthreads above ordered every read of it).
  float* scratch = reinterpret_cast<float*>(&As[0][0]) + warp * 256;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wm * WM + i * 16 + (e >> 4);
        const int gn = n0 + wn * WN + j * 16 + (e & 15);
        if (gm < M && gn < N) {
          const size_t o = static_cast<size_t>(gm) * N + gn;
          float v = scratch[e];
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
      }
      __syncwarp();
    }
  }
}

template <bool kATrans, bool kBTrans>
int launch(const void* a, const void* b, int M, int N, int K, const Epilogue& ep, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<kATrans, kBTrans><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), M, N, K, ep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = act(x . w^T + bias) rounded to bf16 (+ res); `preact`, if not null,
// receives x . w^T + bias in fp32. x [M, K], w [N, K], y/res [M, N].
extern "C" int vt_gemm_bias_act(const void* x, const void* w, const void* bias, const void* res,
                                void* y, void* preact, int M, int N, int K, int act,
                                void* stream) {
  Epilogue ep{static_cast<const float*>(bias), nullptr, kNone, act, static_cast<float*>(preact),
              nullptr, static_cast<__nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(res)};
  return launch<false, false>(x, w, M, N, K, ep, stream);
}

// y = (dy . w) [* act'(preact)], into y_f32 (fp32) or y_bf16 (one rounding).
// dy [M, K], w [K, N], preact/y [M, N].
extern "C" int vt_gemm_dgrad(const void* dy, const void* w, const void* preact, void* y_f32,
                             void* y_bf16, int M, int N, int K, int act, void* stream) {
  Epilogue ep{nullptr, static_cast<const float*>(preact), act, kNone, nullptr,
              static_cast<float*>(y_f32), static_cast<__nv_bfloat16*>(y_bf16), nullptr};
  return launch<false, true>(dy, w, M, N, K, ep, stream);
}
