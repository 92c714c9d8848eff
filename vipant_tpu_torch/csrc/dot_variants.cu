// dot_variant: one tensor-core product a . b -> fp32 [M, N] with the operands
// stored in each of the four orientations:
//   NN  a [M, K], b [K, N]      NT  a [M, K], b [N, K]
//   TN  a [K, M], b [K, N]      TT  a [K, M], b [N, K]
//
// Replaces: the Pallas kernel
//   experiments/fused_block_probe.py::_dot_variant_kernel (line 46),
// which asked which `dot_general` orientations Mosaic lowers on the TPU. On
// Hopper the answer is all four, natively: `wgmma` reads each bf16 operand
// from shared memory K-major or MN-major, as an immediate transpose bit says.
// An operand stored with K contiguous (a in NN/NT, b in NT/TT) is K-major; one
// stored with M or N contiguous (a in TN/TT, b in NN/TN) is MN-major. So the
// four orientations are one kernel that reads the stored tiles as they are:
// nothing is transposed on the host, in registers or in shared memory.
//
// Bound: at the probe's M, K, N = 256, 128, 384 the bytes (a and b read once,
// the fp32 result written once: 544 KB, 0.16 us at 3.35 TB/s), far below one
// launch (0.84 us for an empty one) and one memory round trip; the 25 MFLOP
// take 0.03 us of the tensor cores. With K = 1024 a block's 64 x 64 x 1024
// products alone take 1.1 us of its SM's tensor cores.
//
// Design: one block per 64 x 64 output tile (24 at the probe's shape: 64 x 128
// tiles, 12 blocks, read slower at every case of chip_smoke.DOT_CASES), one
// warpgroup (4 warps). Thread 0 asks TMA (`cp.async.bulk.tensor` under the
// 128-byte swizzle, each stage's bytes counted on its mbarrier) for the
// operand tiles in stages of 128 k, in the orientation they are stored in:
//   K-major operand:  two boxes of 64 k (128 bytes) x the tile's 64 rows, side
//                     by side; a k step of 16 is +32 bytes on the descriptor's
//                     address inside a box (gemm_fwd.cu's form);
//   MN-major operand: one box of 64 M or N elements (128 bytes) x 128 k rows;
//                     a k step of 16 is 16 rows further on (gemm_wgrad.cu's
//                     form).
// Up to kMaxStages stages are in shared memory at once. Where K <= 512 every
// stage is asked for before the first product, so the block waits on one
// memory round trip; past that the stages are a ring whose slots thread 0
// refills once all four warps have released them (gemm_dgrad.cu's form: no
// producer warp). The ring's slot and phase advance by counting: a division
// by the runtime stage count in every step cost ~0.2 us a step. The
// warpgroup issues `wgmma.mma_async` m64n64k16 from shared-memory
// descriptors, the orientation as the two transpose bits, one group of eight
// per stage, one group in flight while the slot before it is released.
// (experiments/dot_variant_sweep.py tries the tile width, the stage depth and
// count, and knocks parts out.)
//
// Epilogue: the fp32 sums stored straight from the accumulator registers as
// float2 pairs (a quad of lanes writes 32 contiguous bytes of a row); rows
// past M and columns past N are left out (N is a multiple of 16, so a pair is
// wholly in or out). Tails: TMA fills whatever a box holds outside a matrix
// with zeros, so a partial tile or a K tail needs no code in the loop. K = 0
// runs the kernel with no stage and no tensor map: it stores zeros.
//
// No atomics and no split over K: the same inputs give the same bits in every
// run. `wgmma` sums k in the same order whatever the operands' major-ness, so
// the four storages of one logical product give the same bits
// (chip_smoke.py's probe phase and the GPU tests check it).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 64;                          // output rows of a block: one warpgroup's wgmma
constexpr int BN = 64;                          // output columns of a block
constexpr int BK = 128;                         // k per stage (a multiple of 64)
constexpr int kSpan = 64;                       // bf16 of a 128-byte swizzled row: every box's width
constexpr int kMaxStages = 4;                   // stages in shared memory at once: K <= 512 in one trip
constexpr int kThreads = 128;                   // one warpgroup; thread 0 also feeds the stages
constexpr int kABytes = BM * BK * 2;            // a's part of a stage: 64 rows x BK k, either way
constexpr int kStageBytes = kABytes + BN * BK * 2;

constexpr int smem_bytes(int stages) {  // 1024: alignment of the swizzled boxes
  return 1024 + stages * kStageBytes + 2 * stages * 8;
}

int dot_stages(int K) {
  const int steps = (K + BK - 1) / BK;
  return steps < kMaxStages ? steps : kMaxStages;
}

// byte offset of k step k (16 k) in a stage's operand: K-major, BK / 64 boxes
// of kRows rows x 128 bytes side by side along k, 32 bytes a step inside a
// row; MN-major, boxes of BK k rows x 128 bytes, 16 rows a step
template <bool kKMajor, int kRows>
__device__ __forceinline__ constexpr uint32_t k_step(int k) {
  return kKMajor ? (k / 4) * kRows * 128 + (k % 4) * 32 : k * 16 * 128;
}

// TA: a stored [K, M] (MN-major); TB: b stored [N, K] (K-major). One block per
// (BN columns, 64 rows) of the output; `stages` slots of a ring over the
// K / BK stages (0 when K = 0).
template <bool TA, bool TB>
__global__ void __launch_bounds__(kThreads)
dot_variant_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                   float* __restrict__ out, int M, int N, int K, int stages) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t tiles = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle wants 1,024-byte boxes
  const uint32_t full = tiles + stages * kStageBytes;            // one mbarrier per slot: filled
  const uint32_t empty = full + stages * 8;                      // one per slot: read by all 4 warps

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nsteps = (K + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // thread 0 loads the stages in order: stage `next` (k from next * BK) into
  // slot `fill`, once every warp has released the slot's previous stage. The
  // slot and parities advance by counting, with no division: the first round
  // finds every slot empty (parity 1 passes on a fresh barrier).
  int next = 0, fill = 0;
  uint32_t fill_parity = 1;
  const auto load_next = [&]() {
    if (next >= nsteps) return;
    const uint32_t dst = tiles + fill * kStageBytes, bar = full + 8 * fill;
    const int k0 = next * BK;
    mbar_wait(empty + 8 * fill, fill_parity);
    mbar_expect_tx(bar, kStageBytes);
    if (TA) {
      tma_load(dst, &map_a, bar, m0, k0);  // a [K, M]: BK k rows x 64 m
    } else {
#pragma unroll
      for (int j = 0; j < BK / kSpan; ++j)  // a [M, K]: 64 m rows x 64 k, BK / 64 boxes
        tma_load(dst + j * BM * 128, &map_a, bar, k0 + kSpan * j, m0);
    }
#pragma unroll
    for (int j = 0; j < (TB ? BK : BN) / kSpan; ++j) {
      if (TB) tma_load(dst + kABytes + j * BN * 128, &map_b, bar, k0 + kSpan * j, n0);  // b [N, K]: BN n rows x 64 k
      else    tma_load(dst + kABytes + j * BK * 128, &map_b, bar, n0 + kSpan * j, k0);  // b [K, N]: BK k rows x 64 n
    }
    ++next;
    if (++fill == stages) fill = 0, fill_parity ^= 1;
  };
  // thread 0 asks for the first stages as soon as the barriers exist; the
  // other threads wait for them at __syncthreads
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads / 32);
    }
    mbar_fence_init();
    for (int s = 0; s < stages; ++s) load_next();
  }
  __syncthreads();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_acc(acc);
  int slot = 0, prev = 0;
  uint32_t parity = 0;
  for (int it = 0; it < nsteps; ++it) {
    mbar_wait(full + 8 * slot, parity);
    const uint32_t stage = tiles + slot * kStageBytes;
    // MN-major: LBO from one box of 64 elements to the next (b, BN = 128)
    const uint64_t desc_a = sw128_desc(stage, TA ? BK * 128 : 16);
    const uint64_t desc_b = sw128_desc(stage + kABytes, TB ? 16 : BK * 128);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)  // the address in the descriptor's 16-byte units
      wgmma_m64n64k16<TA, !TB>(acc, desc_a + (k_step<!TA, BM>(k) >> 4), desc_b + (k_step<TB, BN>(k) >> 4));
    wgmma_commit();
    if (it > 0) {
      wgmma_wait<1>();  // the group before this one has read its slot
      if (lane == 0) mbar_arrive(empty + 8 * prev);
      if (threadIdx.x == 0) load_next();
    }
    prev = slot;
    if (++slot == stages) slot = 0, parity ^= 1;
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // accumulator 4 j + 2 h + e: row r + 8 h, column c + 8 j + e (hopper.cuh)
  const int r = m0 + warp * 16 + (lane >> 2);
  const int c = n0 + (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = c + j * 8;
    if (col < N) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (r + 8 * h < M)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(r + 8 * h) * N + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <bool TA, bool TB>
int launch(const void* a, const void* b, void* out, int M, int N, int K, cudaStream_t s) {
  const auto kernel = dot_variant_kernel<TA, TB>;
  const int stages = dot_stages(K), smem = smem_bytes(stages);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_a = {}, map_b = {};  // K = 0: no stage reads them
  if (K > 0 && !((TA ? make_map(&map_a, a, K, M, BK) : make_map(&map_a, a, M, K, BM)) &&
                 (TB ? make_map(&map_b, b, N, K, BN) : make_map(&map_b, b, K, N, BK))))
    return static_cast<int>(cudaErrorNotSupported);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, s>>>(map_a, map_b, static_cast<float*>(out), M, N, K, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [M, N] fp32; trans_a: a is stored [K, M]; trans_b: b is stored [N, K];
// M, N, K multiples of 16, a and b 16-byte aligned (TMA's rules)
extern "C" int vt_dot_variant(const void* a, const void* b, void* out, int M, int N, int K,
                              int trans_a, int trans_b, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K < 0 || M % 16 != 0 || N % 16 != 0 || K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (trans_a) return trans_b ? launch<true, true>(a, b, out, M, N, K, s)
                              : launch<true, false>(a, b, out, M, N, K, s);
  return trans_b ? launch<false, true>(a, b, out, M, N, K, s)
                 : launch<false, false>(a, b, out, M, N, K, s);
}

// the launch vt_dot_variant makes for these shapes, as kernels.dot_plan
// computes it: plan[0] BN, plan[1] the stages in shared memory, plan[2] blocks
extern "C" int vt_dot_plan(int M, int N, int K, int* plan) {
  plan[0] = BN;
  plan[1] = dot_stages(K);
  plan[2] = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  return 0;
}
