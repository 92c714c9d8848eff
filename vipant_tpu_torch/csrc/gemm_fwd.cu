// gemm_bias_act: the forward products of both fused sub-blocks,
//
//   Y = act(X . W^T + b) rounded once to bf16 (+ residual)   X [M, K], W [N, K]
//
// bf16 in, fp32 accumulate; optionally the fp32 pre-activation X . W^T + b.
//
// Replaces: the matrix products inside the Pallas kernels
//   vipant_tpu/ops/fused_attn.py::_fwd_kernel (qkv projection, line 99;
//     out-projection + residual, lines 112-114),
//   vipant_tpu/ops/fused_mlp.py::_fwd_kernel (fc + activation, lines 54-55;
//     proj + residual, lines 56-57) and
//   vipant_tpu/ops/fused_mlp.py::_bwd_kernel (the recomputed fc with its
//     fp32 pre-activation, line 74).
// The TPU kernels held whole [T, 4C] intermediates in VMEM; a Hopper block
// has 227 KB of shared memory and blocks run in parallel, so each product is
// its own launch and the intermediates make one round trip through device
// memory.
//
// Bound: at M = 19,584 (the audio tower at batch 64) tensor-core operations,
// 2 M N K against 989 TFLOP/s (qkv 0.070 ms); at the caption decoder's T = 1
// (M = 4 to 256) the bytes of W (2 MB for 512 x 2048), a microsecond, which
// a few blocks walking K = 2,048 one stage at a time cannot approach.
//
// Design: Hopper's `wgmma.mma_async` m64n128k16 from shared memory by
// descriptor. Both operands are K-major (a row holds 64 consecutive k, 128
// bytes), the non-transposed case, under the 128-byte swizzle; a k step of 16
// inside the row is taken by adding 32 bytes to the descriptor's address. A
// block computes 128 x 128 tiles: one producer thread fills a ring of
// kStages stages (X and W boxes of 128 rows x 64 k, 32 KB) by TMA
// (`cp.async.bulk.tensor` from tensor maps encoded per call; completion
// counted on an mbarrier), two consumer warpgroups own 64 x 128 each and keep
// one group of four `wgmma` in flight while releasing the stage before it.
// At K = 768 a tile is only 12 steps of 64, so what a block does around its
// products decides the speed. The blocks are persistent, two an SM (3 stages
// = 96 KB each), each walking the tiles blockIdx.x, blockIdx.x + gridDim.x,
// ...: the producer runs on into the next tile while the consumers finish
// the last, so no tile waits for its ring to fill, and one block's epilogue
// overlaps the other block's products. (Measured on the H100, PERF.md §6:
// 128 x 256 tiles, one block an SM with 232 registers after `setmaxnreg`,
// lose to this where the epilogue is heavy: QuickGELU, the fp32
// pre-activation.) TMA zero-fills rows past M and N and k past K, so ragged
// shapes need no code in the loop; K % 8 == 0 is TMA's 16-byte stride rule.
// The accumulators live in registers only if every index into them is a
// constant and nothing but `wgmma` touches them while a group is in flight
// (fence_acc): otherwise the compiler keeps them in local memory and
// serialises the `wgmma` (ptxas C7514), several times slower.
//
// Epilogue (gemm_epilogue.cuh) straight from the accumulator registers: a
// lane holds two rows and, of every 8 columns, two neighbours, so bias,
// pre-activation, output and residual move as pairs (8-byte fp32, 4-byte
// bf16 accesses; a quad covers 16 or 32 contiguous bytes of a row). The
// bias and residual of 32 columns are loaded before any of their stores:
// the compiler keeps a load behind every store that may alias it, and loads
// taken pair by pair, each behind the last store, wait longer than the
// products take at K = 768.
//
// Small M (the caption decoder's T = 1: M = 4 to 256) gives only 4 to 16
// tiles, each walking all of K in one block; the decode is bound by the
// host's launches, not by these blocks (PERF.md §6). Odd N takes a second
// kernel: the blocks write their raw fp32 tiles and it applies the epilogue
// element by element, so this kernel keeps only the pair epilogue.
// No atomics: the same inputs give the same bits in every run.

#include "gemm_epilogue.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using namespace gemm_epi;

constexpr int BM = 128, BN = 128;  // output tile
constexpr int BK = 64;             // k per stage: one 128-byte swizzled row
constexpr int kStages = 3;
constexpr int kBoxBytes = 128 * BK * 2;             // one TMA box: 128 rows x 128 bytes
constexpr int kStageBytes = 2 * kBoxBytes;          // X, W
constexpr int kConsumerWarps = 8;                   // two warpgroups, 64 x 128 of the tile each
constexpr int kThreads = kConsumerWarps * 32 + 32;  // and one producer warp
constexpr int kBlocksPerSM = 2;
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;  // 1024: alignment

// persistent: tile t = (M tile, N tile), N fastest, for t = blockIdx.x,
// blockIdx.x + gridDim.x, ...; partial: null (the epilogue here; N even) or
// [M, N] fp32 (the raw sums, for the second kernel; N odd). kAct is ep.act.
template <int kAct>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
gemm_fwd_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                Epilogue ep, float* __restrict__ partial, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t tiles = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle wants 1,024-byte boxes
  const uint32_t full = tiles + kStages * kStageBytes;           // one mbarrier per stage: filled
  const uint32_t empty = full + kStages * 8;                     // one per stage: read by all consumers

  const int tn = (N + BN - 1) / BN, total = tn * ((M + BM - 1) / BM), nsteps = (K + BK - 1) / BK;
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
    // producer: one thread keeps the ring full across all of this block's
    // tiles; the first pass over the ring finds every stage empty (parity 1
    // passes on a fresh barrier)
    if (lane == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const int m0 = t / tn * BM, n0 = t % tn * BN;
        for (int ks = 0; ks < nsteps; ++ks, ++it) {
          const int s = it % kStages;
          mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, kStageBytes);
          const uint32_t dst = tiles + s * kStageBytes;
          tma_load(dst, &map_x, full + 8 * s, ks * BK, m0);
          tma_load(dst + kBoxBytes, &map_w, full + 8 * s, ks * BK, n0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns tile rows [64 wg, 64 wg + 64) (the second
  // half of X's box, 64 rows x 128 bytes on) against all 128 rows of W's box
  const int wg = warp >> 2;
  float acc[64];
  int it = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int m0 = t / tn * BM, n0 = t % tn * BN;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    fence_acc(acc);
    for (int ks = 0; ks < nsteps; ++ks, ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const uint32_t stage = tiles + s * kStageBytes;
      const uint64_t desc_x = sw128_desc(stage + wg * 64 * 128, 16);
      const uint64_t desc_w = sw128_desc(stage + kBoxBytes, 16);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)  // 16 k further on: 32 bytes, in the descriptor's 16-byte units
        wgmma_m64n128k16<0, 0>(acc, desc_x + 2 * k, desc_w + 2 * k);
      wgmma_commit();
      if (ks > 0) {
        wgmma_wait<1>();  // the group before this one has read its stage
        if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));

    // accumulator 4 j + 2 h + e: row r + 8 h, column c + 8 j + e (hopper.cuh)
    const int r = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
    const int c = n0 + (lane & 3) * 2;
    if (partial != nullptr) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = c + j * 8;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r + 8 * h;
          if (row < M && col < N) {
            const size_t o = static_cast<size_t>(row) * N + col;
            partial[o] = acc[4 * j + 2 * h];
            if (col + 1 < N) partial[o + 1] = acc[4 * j + 2 * h + 1];
          }
        }
      }
    } else {
      // column pairs (N even). The compiler may not move a load above a
      // store that could alias it, so each group's bias and residual are
      // loaded first: one round trip to memory per kGroup x 8 columns.
      constexpr int kGroup = 4;
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += kGroup) {
        float2 bias[kGroup];
        __nv_bfloat162 res[kGroup][2];
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj) {
          const int col = c + (j0 + jj) * 8;
          bias[jj] = ep.bias != nullptr && col < N ? *reinterpret_cast<const float2*>(ep.bias + col)
                                                   : make_float2(0.f, 0.f);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r + 8 * h;
            res[jj][h] = ep.residual != nullptr && row < M && col < N
                             ? *reinterpret_cast<const __nv_bfloat162*>(ep.residual +
                                                                        static_cast<size_t>(row) * N + col)
                             : __floats2bfloat162_rn(0.f, 0.f);
          }
        }
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj) {
          const int col = c + (j0 + jj) * 8;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r + 8 * h;
            if (row < M && col < N)
              epilogue_pair<kAct>(ep, acc[4 * (j0 + jj) + 2 * h], acc[4 * (j0 + jj) + 2 * h + 1], bias[jj],
                                  res[jj][h], static_cast<size_t>(row) * N + col);
          }
        }
      }
    }
  }
}

// y = epilogue(partial), element by element (odd N)
__global__ void gemm_fwd_epilogue_kernel(const float* __restrict__ partial, Epilogue ep, int N, size_t MN) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  epilogue_at(ep, partial[i], i, static_cast<int>(i % N));
}

int sms[64];  // the SMs of each device whose shared-memory limits are raised (prepare_device)

}  // namespace

// y = act(x . w^T + bias) rounded to bf16 (+ res); `preact`, if not null,
// receives x . w^T + bias in fp32. x [M, K], w [N, K], y/res [M, N], K % 8
// == 0; partial: [M, N] fp32 scratch for odd N (may be null otherwise).
extern "C" int vt_gemm_bias_act(const void* x, const void* w, const void* bias, const void* res,
                                void* y, void* preact, void* partial, int M, int N, int K, int act,
                                void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const bool odd = N & 1;  // raw fp32 sums, then the epilogue in a second kernel
  if (K <= 0 || K % 8 != 0 || (odd && partial == nullptr) || act < kNone || act > kGelu)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slots = kBlocksPerSM * prepare_device(sms, kSmemBytes, gemm_fwd_kernel<kNone>,
                                                  gemm_fwd_kernel<kQuickGelu>, gemm_fwd_kernel<kGelu>);
  if (slots <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  CUtensorMap map_x, map_w;
  if (!make_map(&map_x, x, M, K, BM) || !make_map(&map_w, w, N, K, BN))
    return static_cast<int>(cudaErrorNotSupported);
  const Epilogue ep{static_cast<const float*>(bias), act, static_cast<float*>(preact),
                    static_cast<__nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(res)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  const dim3 grid(static_cast<unsigned>(total < slots ? total : slots));
  float* const part = odd ? static_cast<float*>(partial) : nullptr;
  const auto kernel = act == kQuickGelu ? gemm_fwd_kernel<kQuickGelu>
                      : act == kGelu    ? gemm_fwd_kernel<kGelu>
                                        : gemm_fwd_kernel<kNone>;
  kernel<<<grid, kThreads, kSmemBytes, s>>>(map_x, map_w, ep, part, M, N, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !odd) return static_cast<int>(err);
  const size_t MN = static_cast<size_t>(M) * N;
  gemm_fwd_epilogue_kernel<<<static_cast<unsigned>((MN + 255) / 256), 256, 0, s>>>(part, ep, N, MN);
  return static_cast<int>(cudaGetLastError());
}
