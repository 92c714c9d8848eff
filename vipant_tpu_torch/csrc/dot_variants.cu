// dot_variant: one tensor-core product a . b -> fp32 [M, N] with the operands
// stored in each of the four orientations:
//   NN  a [M, K], b [K, N]      NT  a [M, K], b [N, K]
//   TN  a [K, M], b [K, N]      TT  a [K, M], b [N, K]
//
// Replaces: the Pallas kernel
//   experiments/fused_block_probe.py::_dot_variant_kernel (line 46),
// which asked which `dot_general` orientations Mosaic lowers on the TPU. On
// Hopper the orientation is the layout of the wmma fragments (row- or
// column-major for each operand), chosen here at compile time: no operand is
// transposed on the host or in shared memory. All four must work and agree.
//
// One warp per 16 x 16 output tile, fragments loaded straight from global
// memory; M, N and K are multiples of 16 (checked by the wrapper). A probe,
// not a fast GEMM: at M, K, N = 256, 128, 384 it is bound by launch latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kWarps = 4;

template <bool TA, bool TB>
__global__ void __launch_bounds__(kWarps * 32)
dot_variant_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                   float* __restrict__ out, int M, int N, int K) {
  using LayoutA = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
  using LayoutB = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;
  const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int tiles_n = N / 16;
  if (tile >= (M / 16) * tiles_n) return;  // whole warps leave together
  const int m0 = (tile / tiles_n) * 16, n0 = (tile % tiles_n) * 16;
  const int lda = TA ? M : K, ldb = TB ? K : N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
  wmma::fill_fragment(c, 0.f);
  for (int k0 = 0; k0 < K; k0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LayoutA> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayoutB> fb;
    // element (m, k) of a: a[m * K + k] as stored, or a[k * M + m] transposed;
    // element (k, n) of b: b[k * N + n] as stored, or b[n * K + k] transposed
    wmma::load_matrix_sync(fa, TA ? a + static_cast<size_t>(k0) * lda + m0
                                  : a + static_cast<size_t>(m0) * lda + k0, lda);
    wmma::load_matrix_sync(fb, TB ? b + static_cast<size_t>(n0) * ldb + k0
                                  : b + static_cast<size_t>(k0) * ldb + n0, ldb);
    wmma::mma_sync(c, fa, fb, c);
  }
  wmma::store_matrix_sync(out + static_cast<size_t>(m0) * N + n0, c, N, wmma::mem_row_major);
}

template <bool TA, bool TB>
int launch(const void* a, const void* b, void* out, int M, int N, int K, cudaStream_t s) {
  const int tiles = (M / 16) * (N / 16);
  dot_variant_kernel<TA, TB><<<(tiles + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<float*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [M, N] fp32; trans_a: a is stored [K, M]; trans_b: b is stored [N, K]
extern "C" int vt_dot_variant(const void* a, const void* b, void* out, int M, int N, int K,
                              int trans_a, int trans_b, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (trans_a) return trans_b ? launch<true, true>(a, b, out, M, N, K, s)
                              : launch<true, false>(a, b, out, M, N, K, s);
  return trans_b ? launch<false, true>(a, b, out, M, N, K, s)
                 : launch<false, false>(a, b, out, M, N, K, s);
}
