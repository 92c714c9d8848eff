// gemm_bias_act: Y = epilogue(X . W^T + b), bf16 in, fp32 accumulate, bf16 out.
//
// Replaces: the matrix products inside the Pallas kernels
//   vipant_tpu/ops/fused_attn.py::_fwd_kernel (qkv projection, line 99;
//     out-projection + residual, lines 112-114) and
//   vipant_tpu/ops/fused_mlp.py::_fwd_kernel (fc + activation, lines 54-55;
//     proj + residual, lines 56-57).
// The TPU kernel held a whole [T, 4C] intermediate in VMEM; a Hopper block
// has 227 KB of shared memory, so each product is its own launch and the
// intermediate makes one bf16 round trip through device memory.
//
// Bound: tensor-core operations at the slice's shapes (M = B*T in the
// thousands, N and K in 512..3072); this first version uses warp-level
// `nvcuda::wmma` 16x16x16 tiles, not Hopper's `wgmma`, so it reaches only a
// share of the card's bf16 peak.
//
// Design: X is [M, K] row-major, W is [N, K] row-major (the torch Linear /
// MultiheadAttention layout), so both operands are K-contiguous. A block
// computes a 128x128 tile of Y with 8 warps (2 x 4, 64x32 each), walking K
// in steps of 32 through a two-stage cp.async ring in shared memory. Rows
// past M and columns past N are zero-filled on load and masked on store
// (M = B*T is ragged: T = 306, 308, 200). The epilogue follows the Pallas
// rounding order: fp32 sum + fp32 bias -> activation in fp32 -> one bf16
// rounding -> optional residual added in bf16 (computed in fp32, rounded).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDS = BK + 8;  // padded row: 80 bytes, keeps 16-byte cp.async alignment
constexpr int kThreads = 256;
constexpr int WM = 64, WN = 32;            // warp tile
constexpr int FM = WM / 16, FN = WN / 16;  // 4 x 2 accumulator fragments per warp

enum Act : int { kNone = 0, kQuickGelu = 1, kGelu = 2 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // src-size 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// One BM x BK (or BN x BK) tile of a K-contiguous [rows, K] matrix; 16-byte
// chunks, two per thread. K % 8 == 0, so a chunk is wholly in or out.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int rows, int k0, int K) {
#pragma unroll
  for (int i = 0; i < (BM * BK / 8) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 2, kc = (c & 3) * 8;
    const int gr = row0 + r, gk = k0 + kc;
    const bool in = gr < rows && gk < K;
    const __nv_bfloat16* g = in ? src + static_cast<size_t>(gr) * K + gk : src;
    cp_async16(dst + r * LDS + kc, g, in);
  }
}

__global__ void __launch_bounds__(kThreads)
gemm_bias_act_kernel(const __nv_bfloat16* __restrict__ X, const __nv_bfloat16* __restrict__ W,
                     const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
                     __nv_bfloat16* __restrict__ Y, int M, int N, int K, int act) {
  __shared__ __align__(128) __nv_bfloat16 As[2][BM * LDS];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][BN * LDS];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (K + BK - 1) / BK;
  load_tile(As[0], X, m0, M, 0, K);
  load_tile(Bs[0], W, n0, N, 0, K);
  cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) {
      load_tile(As[s ^ 1], X, m0, M, (kt + 1) * BK, K);
      load_tile(Bs[s ^ 1], W, n0, N, (kt + 1) * BK, K);
    }
    cp_async_commit();  // possibly empty: keeps "all but the newest group" meaning tile kt
    cp_async_wait_one();
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], &As[s][(wm * WM + i * 16) * LDS + kk], LDS);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], &Bs[s][(wn * WN + j * 16) * LDS + kk], LDS);
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
          float v = __fadd_rn(scratch[e], bias[gn]);
          if (act == kQuickGelu) {
            v = v * (1.f / (1.f + expf(-1.702f * v)));
          } else if (act == kGelu) {
            v = v * (erff(v * 0.70710678118654752f) + 1.f) * 0.5f;
          }
          const size_t o = static_cast<size_t>(gm) * N + gn;
          __nv_bfloat16 y = __float2bfloat16(v);
          if (res != nullptr)
            y = __float2bfloat16(__bfloat162float(res[o]) + __bfloat162float(y));
          Y[o] = y;
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int vt_gemm_bias_act(const void* x, const void* w, const void* bias, const void* res,
                                void* y, int M, int N, int K, int act, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bias_act_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(y), M, N, K, act);
  return static_cast<int>(cudaGetLastError());
}
