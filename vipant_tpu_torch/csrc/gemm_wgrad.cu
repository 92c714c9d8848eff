// gemm_wgrad: the weight grads of both fused sub-blocks,
//
//   Y [N1, N2] fp32 = A^T . B   summed over the M rows of A [M, N1], B [M, N2],
//
// both bf16 and stored row-contiguous, so the reduction runs along the
// strided dimension of both operands (M = B*T rows: 19,584 for the audio
// tower at batch 64, 4,928 for the caption decoder).
//
// Replaces: the weight-grad products inside the Pallas kernels
//   vipant_tpu/ops/fused_attn.py::_bwd_kernel (dWout, line 220; dWqkv, line 232),
//   vipant_tpu/ops/fused_mlp.py::_bwd_kernel (dWproj, line 79; dWfc, line 83).
// The TPU kernels summed the weight grads over a sequential grid, one item
// at a time. On Hopper the blocks run in parallel and nothing carries over,
// and the output is small (36 to 144 tiles of 128 x 128 for 132 SMs) while
// the reduction is long. So the rows are split as well:
//
//   wgrad_kernel         grid (N2 tiles, N1 tiles, S row chunks); a block sums
//                        its chunk of rows into one fp32 128 x 128 tile and
//                        writes it to partial[chunk] (to Y itself when S = 1);
//   wgrad_reduce_kernel  Y = partial[0] + partial[1] + ... in that order.
//
// No atomics: the result is bitwise the same in every run. S and the chunk
// length come from the wrapper (`wgrad_split` in ops/kernels.py), a function
// of the shapes only. The partials cost S * N1 * N2 * 4 bytes written and
// read once more. At M = 19,584: dWout (768 x 768, S = 7) 33 MB, 10 us at
// the memory rate beside the product's 23 us bound, though they mostly stay
// in the 50 MB L2; dWqkv (S = 2) 28 MB, 8 us beside 70; dWproj and dWfc
// (S = 3) 57 MB, 17 us beside 93. A cluster reducing through distributed
// shared memory would save that round trip only where S <= 4 chunks of a
// tile run at once; it is not done here.
//
// Bound: tensor-core operations (2 * M * N1 * N2 against 989 TFLOP/s). The
// design is Hopper's: `wgmma.mma_async` m64n128k16, bf16 in, fp32
// accumulators in registers, both operands read from shared memory by
// descriptor. Both operands are MN-major here (64 consecutive columns of a
// row are the contiguous 128 bytes, the reduction index is the strided one),
// which bf16 `wgmma` takes through its transpose bits with the 128-byte
// swizzle: nothing is transposed in device memory or on the way in.
//
// Shared memory is a ring of kStages stages, each [64 rows of M] x [128
// columns] of A and of B (32 KB), filled by TMA (`cp.async.bulk.tensor`
// from tensor maps encoded on the host for this call, completion counted on
// an mbarrier) from one producer thread; two consumer warpgroups own 64 x 128
// of the tile each and keep one group of four `wgmma` in flight while they
// release the stage before it. TMA rather than cp.async: it writes the
// 128-byte swizzle the descriptors name, spends no registers or instruction slots
// of the consumers, and zero-fills whatever a box holds past M, N1 or N2, so
// ragged shapes need no code in the loop (columns past N1, N2 are masked on
// store). The barrier, TMA, descriptor and `wgmma` helpers are hopper.cuh's,
// shared with gemm_fwd.cu. Two blocks fit on an SM (3 stages = 96 KB each), so one block's store
// overlaps the other's products.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128, BN = 128;  // output tile: columns of A x columns of B
constexpr int BK = 64;             // rows of the reduction per stage
constexpr int kStages = 3;
constexpr int kBoxCols = 64;                    // 64 bf16 = the 128-byte swizzle span
constexpr int kBoxBytes = BK * kBoxCols * 2;    // one TMA box: 64 rows x 128 bytes
constexpr int kStageBytes = 4 * kBoxBytes;      // A: 2 boxes, B: 2 boxes
constexpr int kConsumerWarps = 8;               // two warpgroups, 64 x 128 of the tile each
constexpr int kThreads = kConsumerWarps * 32 + 32;  // and one producer warp
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;  // 1024: alignment

__global__ void __launch_bounds__(kThreads, 2)
wgrad_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
             float* __restrict__ out, int N1, int N2, int M, int rows_per_chunk) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t tiles = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle wants 1,024-byte boxes
  const uint32_t full = tiles + kStages * kStageBytes;           // one mbarrier per stage: filled
  const uint32_t empty = full + kStages * 8;                     // one per stage: read by all consumers

  const int n2_0 = blockIdx.x * BN, n1_0 = blockIdx.y * BM;
  const int row0 = blockIdx.z * rows_per_chunk;
  const int rows = min(M - row0, rows_per_chunk);
  const int nsteps = (rows + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: one thread keeps the ring full; the first pass over the
    // ring finds every stage empty (parity 1 passes on a fresh barrier)
    if (lane == 0) {
      for (int it = 0; it < nsteps; ++it) {
        const int s = it % kStages;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, kStageBytes);
        const uint32_t dst = tiles + s * kStageBytes;
        const int row = row0 + it * BK;
        tma_load(dst, &map_a, full + 8 * s, n1_0, row);
        tma_load(dst + kBoxBytes, &map_a, full + 8 * s, n1_0 + kBoxCols, row);
        tma_load(dst + 2 * kBoxBytes, &map_b, full + 8 * s, n2_0, row);
        tma_load(dst + 3 * kBoxBytes, &map_b, full + 8 * s, n2_0 + kBoxCols, row);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns tile rows [64 wg, 64 wg + 64), the columns
  // of A's box wg, against all 128 columns of B (two boxes, LBO apart)
  const int wg = warp >> 2;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int it = 0; it < nsteps; ++it) {
    const int s = it % kStages;
    mbar_wait(full + 8 * s, (it / kStages) & 1);
    const uint32_t stage = tiles + s * kStageBytes;
    const uint64_t desc_a = sw128_desc(stage + wg * kBoxBytes, kBoxBytes);
    const uint64_t desc_b = sw128_desc(stage + 2 * kBoxBytes, kBoxBytes);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) {
      // 16 reduction rows further on: 16 x 128 bytes, in the descriptor's 16-byte units
      const uint64_t step = static_cast<uint64_t>(k * 16 * 128) >> 4;
      wgmma_m64n128k16<1, 1>(acc, desc_a + step, desc_b + step);
    }
    wgmma_commit();
    if (it > 0) {
      wgmma_wait<1>();  // the group before this one has read its stage
      if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
    }
  }
  wgmma_wait<0>();

  // accumulator i of lane l in warp w of the warpgroup: row 16 w + l / 4 (+ 8
  // for i % 4 >= 2), column 8 (i / 4) + 2 (l % 4) + i % 2
  out += static_cast<size_t>(blockIdx.z) * N1 * N2;
  const int r = n1_0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int c = n2_0 + (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = c + j * 8;
    if (col < N2) {  // N2 is a multiple of 8: the pair is in or out together
      if (r < N1)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * N2 + col) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (r + 8 < N1)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(r + 8) * N2 + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// y = partial[0] + partial[1] + ... + partial[S - 1], in that order
__global__ void wgrad_reduce_kernel(const float4* __restrict__ partial, float4* __restrict__ y,
                                    int n4, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 acc = partial[i];
  for (int s = 1; s < S; ++s) {
    const float4 v = partial[static_cast<size_t>(s) * n4 + i];
    acc.x = __fadd_rn(acc.x, v.x);
    acc.y = __fadd_rn(acc.y, v.y);
    acc.z = __fadd_rn(acc.z, v.z);
    acc.w = __fadd_rn(acc.w, v.w);
  }
  y[i] = acc;
}

}  // namespace

// y [N1, N2] fp32 = a^T . b summed over the M rows of a [M, N1], b [M, N2]
// (N1, N2 multiples of 8), the rows cut into S chunks of rows_per_chunk (a
// multiple of 64; the last may be short). partial: [S, N1, N2] fp32 scratch,
// unused (may be null) when S = 1.
extern "C" int vt_gemm_wgrad(const void* a, const void* b, void* y, void* partial, int N1, int N2,
                             int M, int S, int rows_per_chunk, void* stream) {
  if (N1 <= 0 || N2 <= 0) return 0;
  if (M <= 0 || S < 1 || rows_per_chunk % BK != 0 || N1 % 8 != 0 || N2 % 8 != 0 ||
      static_cast<long long>(S - 1) * rows_per_chunk >= M ||
      static_cast<long long>(S) * rows_per_chunk < M || (S > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, a, M, N1, BK) || !make_map(&map_b, b, M, N2, BK))
    return static_cast<int>(cudaErrorNotSupported);
  cudaError_t err = cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N2 + BN - 1) / BN, (N1 + BM - 1) / BM, S);
  wgrad_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      map_a, map_b, static_cast<float*>(S == 1 ? y : partial), N1, N2, M, rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  const int n4 = N1 * N2 / 4;
  wgrad_reduce_kernel<<<(n4 + 255) / 256, 256, 0, s>>>(static_cast<const float4*>(partial),
                                                       static_cast<float4*>(y), n4, S);
  return static_cast<int>(cudaGetLastError());
}
