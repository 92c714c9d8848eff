// gemm_dgrad: the data grads of both fused sub-blocks,
//
//   Y = (dY . W) [* act'(preact)]   dY [M, K], W [K, N], Y [M, N] fp32 or bf16
//
// bf16 in, fp32 accumulate. W is read as stored (the weight of y = x . W^T
// in the torch [out, in] layout): no transposed copy exists anywhere. The
// forward products are gemm_fwd.cu, the weight grads gemm_wgrad.cu.
//
// Replaces: the data-grad products inside the Pallas kernels
//   vipant_tpu/ops/fused_attn.py::_bwd_kernel (do = g.Wout^T, line 217;
//     dh = dqkv.Wqkv^T, line 231) and
//   vipant_tpu/ops/fused_mlp.py::_bwd_kernel (dg . act'(a), lines 80-81;
//     dh, line 84).
// The TPU kernels held whole [T, 4C] intermediates in VMEM; a Hopper block
// has 227 KB of shared memory and blocks run in parallel, so each product is
// its own launch and the intermediates make one round trip through device
// memory.
//
// Bound: at M = 19,584 (the audio tower at batch 64) tensor-core operations
// (2 M N K against 989 TFLOP/s: dh = dqkv . Wqkv 0.070 ms), except the MLP's
// act-grad product, da = (gy . Wproj) * act'(a), which is bound by its bytes:
// 240 MB of fp32 pre-activation in and 120 MB of bf16 out, 0.118 ms.
//
// Design: persistent blocks, two an SM, each walking 128 x 128 output tiles
// (N fastest) over all of K through a ring of kStages stages of 64 k filled
// by TMA (completion counted on mbarriers); two warpgroups own 64 x 128 of
// the tile each and issue `wgmma.mma_async` m64n128k16, keeping one group in
// flight while they release the stage before it. Thread 0 feeds the ring:
// each released stage is refilled at once with the stage kStages further
// on, of this tile or the next, so the next tile's first stages arrive while
// the block stores the last, and the other block on the SM keeps the tensor
// cores busy meanwhile. A separate producer warp (gemm_fwd.cu's form) would
// make 9 warps a block: 18 on the SM, 5 on one of its 4 schedulers, whose
// share of the register file caps a thread at 96 registers; with 8 warps
// the cap is 128 and the 64 accumulators and the epilogue fit without
// spills. Operand A (dY, K contiguous) is K-major, staged and read exactly
// as gemm_fwd.cu stages X: one box of 128 rows x 64 k, a k step of 16 = 32
// bytes on the descriptor's address. Operand B (W, N contiguous) is
// MN-major, staged as gemm_wgrad.cu stages its operands: per stage two boxes
// of 64 k rows x 64 columns (128 bytes, swizzled), LBO one box apart, a k
// step of 16 = 16 rows x 128 bytes; `wgmma` takes it through B's transpose
// bit. TMA zero-fills rows past M, columns past N and k past K, so ragged
// shapes (M = B*T: 19,584, 4,928, 1,224, 111) need no code in the loop; K %
// 8 == 0 and N % 8 == 0 are TMA's 16-byte stride rule for the two operands.
// The accumulators stay in registers only if every index into them is a
// constant and nothing but `wgmma` touches them while a group is in flight
// (fence_acc); otherwise the compiler keeps them in local memory and
// serialises the `wgmma` (ptxas C7514).
//
// Epilogue (gemm_epilogue.cuh: act_grad_pair) straight from the accumulator
// registers, in pairs: a lane holds two rows and, of every 8 columns, two
// neighbours, so the fp32 pre-activation is read and the result written as
// 8-byte (fp32) or 4-byte (bf16) pairs, a quad covering 32 or 16 contiguous
// bytes of a row. The pre-activation pairs of kGroup x 8 columns are loaded
// before any store of those columns (the compiler keeps a load behind every
// store that may alias it). No shared-memory scratch, no atomics, no split
// over K: the same inputs give the same bits in every run.
//
// Tried on the H100 and not kept (PERF.md §6): one block an SM whose two
// warpgroups each own whole tiles and take a 6-stage ring in turns runs the
// plain products faster, but its epilogue has only 4 warps to hide latency
// and the act-grad product, the one that costs most, runs much slower; the
// two-block form with a producer warp loses on the act-grad product to the
// 96-register cap; refilling a stage one step later, so that thread 0 never
// waits for the other warpgroup, loses more than the wait costs; asking L2
// for the tile's pre-activation when its products start gains nothing.

#include "gemm_epilogue.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using namespace gemm_epi;

constexpr int BM = 128, BN = 128;  // output tile
constexpr int BK = 64;             // k per stage
constexpr int kStages = 3;
constexpr int kABytes = BM * BK * 2;                // dY box: 128 rows x 128 bytes
constexpr int kWBoxBytes = BK * 64 * 2;             // W box: 64 k rows x 64 columns (128 bytes)
constexpr int kStageBytes = kABytes + 2 * kWBoxBytes;
constexpr int kConsumerWarps = 8;                   // two warpgroups, 64 x 128 of the tile each
constexpr int kThreads = kConsumerWarps * 32;       // thread 0 also feeds the ring
constexpr int kBlocksPerSM = 2;
constexpr int kGroup = 4;         // epilogue: columns x 8 whose pre-activation is loaded before their stores
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;  // 1024: alignment

// persistent: tile t = (M tile, N tile), N fastest, for t = blockIdx.x,
// blockIdx.x + gridDim.x, ...; kAct: the activation whose grad multiplies
// the sums (kNone: preact unused); out_f32 or out_bf16 receives Y
template <int kAct>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
gemm_dgrad_kernel(const __grid_constant__ CUtensorMap map_dy, const __grid_constant__ CUtensorMap map_w,
                  const float* __restrict__ preact, float* __restrict__ out_f32,
                  __nv_bfloat16* __restrict__ out_bf16, int M, int N, int K) {
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

  // thread 0 feeds the ring: stage g of the block's walk (k step g % nsteps
  // of its tile g / nsteps) into slot g % kStages, once every consumer warp
  // has released the slot's previous stage (g - kStages); the first pass
  // over the ring finds every slot empty (parity 1 passes on a fresh barrier)
  const int nstages = (total - blockIdx.x + gridDim.x - 1) / gridDim.x * nsteps;
  const auto load = [&](int g) {
    if (g >= nstages) return;
    const int s = g % kStages, t = blockIdx.x + g / nsteps * gridDim.x, ks = g % nsteps;
    const int m0 = t / tn * BM, n0 = t % tn * BN;
    mbar_wait(empty + 8 * s, ((g / kStages) & 1) ^ 1);
    mbar_expect_tx(full + 8 * s, kStageBytes);
    const uint32_t dst = tiles + s * kStageBytes;
    tma_load(dst, &map_dy, full + 8 * s, ks * BK, m0);
    tma_load(dst + kABytes, &map_w, full + 8 * s, n0, ks * BK);
    tma_load(dst + kABytes + kWBoxBytes, &map_w, full + 8 * s, n0 + 64, ks * BK);
  };
  if (threadIdx.x == 0)
    for (int g = 0; g < kStages; ++g) load(g);

  // consumers: warpgroup wg owns tile rows [64 wg, 64 wg + 64) (the second
  // half of dY's box, 64 rows x 128 bytes on) against all 128 columns of W
  // (two boxes, LBO apart)
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
      const uint64_t desc_dy = sw128_desc(stage + wg * 64 * 128, 16);
      const uint64_t desc_w = sw128_desc(stage + kABytes, kWBoxBytes);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)  // 16 k further on: 32 bytes of dY's row, 16 rows of W's box
        wgmma_m64n128k16<0, 1>(acc, desc_dy + 2 * k, desc_w + ((k * 16 * 128) >> 4));
      wgmma_commit();
      if (ks > 0) {
        wgmma_wait<1>();  // the group before this one has read its stage
        if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
        if (threadIdx.x == 0) load(it - 1 + kStages);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
    if (threadIdx.x == 0) load(it - 1 + kStages);  // the next tile's stages arrive during the epilogue

    // accumulator 4 j + 2 h + e: row r + 8 h, column c + 8 j + e (hopper.cuh);
    // N is a multiple of 8, so a pair is wholly in or out
    const int r = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
    const int c = n0 + (lane & 3) * 2;
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += kGroup) {
      float2 a[kGroup][2];
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        const int col = c + (j0 + jj) * 8;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r + 8 * h;
          a[jj][h] = kAct != kNone && row < M && col < N
                         ? *reinterpret_cast<const float2*>(preact + static_cast<size_t>(row) * N + col)
                         : make_float2(0.f, 0.f);
        }
      }
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        const int col = c + (j0 + jj) * 8;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r + 8 * h;
          if (row < M && col < N)
            act_grad_pair<kAct>(acc[4 * (j0 + jj) + 2 * h], acc[4 * (j0 + jj) + 2 * h + 1], a[jj][h],
                                out_f32, out_bf16, static_cast<size_t>(row) * N + col);
        }
      }
    }
  }
}

int sms[64];  // the SMs of each device whose shared-memory limits are raised (prepare_device)

}  // namespace

// y = (dy . w) [* act'(preact)], into y_f32 (fp32) or y_bf16 (one rounding).
// dy [M, K], w [K, N], preact/y [M, N]; K % 8 == 0, N % 8 == 0; preact only
// with an activation.
extern "C" int vt_gemm_dgrad(const void* dy, const void* w, const void* preact, void* y_f32,
                             void* y_bf16, int M, int N, int K, int act, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 8 != 0 || N % 8 != 0 || act < kNone || act > kGelu ||
      (act != kNone) != (preact != nullptr) || (y_f32 == nullptr) == (y_bf16 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int slots = kBlocksPerSM * prepare_device(sms, kSmemBytes, gemm_dgrad_kernel<kNone>,
                                                  gemm_dgrad_kernel<kQuickGelu>, gemm_dgrad_kernel<kGelu>);
  if (slots <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  CUtensorMap map_dy, map_w;
  if (!make_map(&map_dy, dy, M, K, BM) || !make_map(&map_w, w, K, N, BK))
    return static_cast<int>(cudaErrorNotSupported);
  const long long total = static_cast<long long>((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  const dim3 grid(static_cast<unsigned>(total < slots ? total : slots));
  const auto kernel = act == kQuickGelu ? gemm_dgrad_kernel<kQuickGelu>
                      : act == kGelu    ? gemm_dgrad_kernel<kGelu>
                                        : gemm_dgrad_kernel<kNone>;
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map_dy, map_w, static_cast<const float*>(preact), static_cast<float*>(y_f32),
      static_cast<__nv_bfloat16*>(y_bf16), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
