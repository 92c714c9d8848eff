// gemm_i8: the int8 x int8 -> int32 matrix products of the int8 sub-blocks,
// with the dequantizing epilogue:
//
//   Y = epilogue(float(Xq . Wq^T) * row_scale[m] * col_scale[n] + bias[n])
//
// Xq [M, K] int8 (per-token codes, quant.cu), Wq [N, K] int8 (per-output-
// column codes in the torch [out, in] layout), row_scale [M], col_scale [N],
// bias [N] fp32.
//
// Replaces: the int8 MXU dots and their dequantization inside the Pallas
// kernels
//   vipant_tpu/ops/fused_attn.py::_fwd_int8_kernel (qkv projection, lines
//     141-148; out-projection + residual, lines 159-165) and
//   vipant_tpu/ops/fused_mlp.py::_fwd_int8_kernel (fc + activation, lines
//     112-114; proj + residual, lines 116-121).
// The TPU kernels ran one batch item per grid step with everything in VMEM;
// here each product is its own launch over tiles of all B*T rows, and the
// activation between the two MLP products leaves in fp32, because the Pallas
// kernel quantizes act(a) from fp32 and the per-token scale needs the whole
// 4C-wide row.
//
// Bound: at M = 19,584 (the audio tower at batch 64) int8 tensor-core
// operations (2 M N K against 1,979 TOP/s: qkv 0.035 ms) where the output is
// bf16; the fc product's fp32 output (240 MB, 0.077 ms) where it is fp32.
//
// Design: gemm_dgrad.cu's, with `wgmma.mma_async` m64n128k32 s32.s8.s8.
// Persistent blocks, two an SM, each walking 128 x 128 output tiles (N
// fastest) over all of K through a ring of kStages stages filled by TMA
// (tensor maps of UINT8, completion counted on mbarriers); two warpgroups
// own 64 x 128 of the tile each and keep one group of `wgmma` in flight
// while they release the stage before it; thread 0 refills each released
// stage at once with the stage kStages further on, of this tile or the
// next. 8 warps a block, no producer warp: 128 registers a thread, no
// spills (with a producer warp the cap is 96, the epilogue spilled up to 800
// bytes and every product ran slower). Both operands are K contiguous,
// the only form 8-bit `wgmma` takes: a 128-byte swizzled row holds 128 k,
// so a stage (an Xq and a Wq box of 128 rows x 128 k, 32 KB) is four k32
// steps of +32 bytes on the descriptors' addresses. TMA zero-fills rows past
// M and N and k past K (K = 80: the stage's last 48 bytes), so ragged shapes
// need no code in the loop; K % 16 == 0 is TMA's stride rule.
// The int32 sums are exact (K = 3,072 codes of +-127 stay far below 2^31).
//
// Epilogue straight from the accumulator registers, in pairs of columns, in
// the Pallas order, every step one fp32 rounding (no fused multiply-add):
// __int2float_rn of the exact sum; times the row scale, then the column
// scale (the column scale first under col_first: the qkv projection of
// _fwd_int8_kernel multiplies in that order); plus bias; the activation;
// then an fp32 store, or one bf16 rounding after which the residual is
// added in bf16. The row scales of a lane's two rows, and the column scales,
// bias and residual of kGroup x 8 columns, are loaded before any store of
// those columns. No atomics: the same inputs give the same bits in every run.

#include "gemm_epilogue.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using gemm_epi::act_fwd;
using gemm_epi::kGelu;
using gemm_epi::kNone;
using gemm_epi::kQuickGelu;

constexpr int BM = 128, BN = 128;  // output tile
constexpr int BK = 128;            // k per stage: one 128-byte swizzled row of codes
constexpr int kStages = 3;
constexpr int kBoxBytes = 128 * BK;                 // one TMA box: 128 rows x 128 bytes
constexpr int kStageBytes = 2 * kBoxBytes;          // Xq, Wq
constexpr int kConsumerWarps = 8;                   // two warpgroups, 64 x 128 of the tile each
constexpr int kThreads = kConsumerWarps * 32;       // thread 0 also feeds the ring
constexpr int kBlocksPerSM = 2;
constexpr int kGroup = 2;         // epilogue: columns x 8 whose scales, bias, residual load before their stores
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;  // 1024: alignment

struct Epilogue {
  const float* row_scale;         // [M]
  const float* col_scale;         // [N]
  const float* bias;              // [N]
  int col_first;                  // multiply by the column scale before the row scale
  float* out_f32;                 // [M, N] fp32 result or null
  __nv_bfloat16* out_bf16;        // [M, N] bf16 result or null
  const __nv_bfloat16* residual;  // added after the bf16 rounding, or null
};

// the sum times s0, then s1 (the row and the column scale in the caller's
// order), plus bias, the activation
template <int kAct>
__device__ __forceinline__ float finish(int sum, float s0, float s1, float bias) {
  return act_fwd(__fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(sum), s0), s1), bias), kAct);
}

// persistent: tile t = (M tile, N tile), N fastest, for t = blockIdx.x,
// blockIdx.x + gridDim.x, ...; kAct is the activation
template <int kAct>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
gemm_i8_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
               Epilogue ep, int M, int N, int K) {
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
    tma_load(dst, &map_x, full + 8 * s, ks * BK, m0);
    tma_load(dst + kBoxBytes, &map_w, full + 8 * s, ks * BK, n0);
  };
  if (threadIdx.x == 0)
    for (int g = 0; g < kStages; ++g) load(g);

  // consumers: warpgroup wg owns tile rows [64 wg, 64 wg + 64) (the second
  // half of Xq's box, 64 rows x 128 bytes on) against all 128 rows of Wq's box
  const int wg = warp >> 2;
  int acc[64];
  int it = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int m0 = t / tn * BM, n0 = t % tn * BN;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    fence_acc(acc);
    for (int ks = 0; ks < nsteps; ++ks, ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const uint32_t stage = tiles + s * kStageBytes;
      const uint64_t desc_x = sw128_desc(stage + wg * 64 * 128, 16);
      const uint64_t desc_w = sw128_desc(stage + kBoxBytes, 16);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 32; ++k)  // 32 codes further on: 32 bytes, in the descriptor's 16-byte units
        wgmma_m64n128k32_s8(acc, desc_x + 2 * k, desc_w + 2 * k);
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
    float rs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) rs[h] = r + 8 * h < M ? ep.row_scale[r + 8 * h] : 0.f;
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += kGroup) {
      float2 cs[kGroup], bias[kGroup];
      __nv_bfloat162 res[kGroup][2];
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        const int col = c + (j0 + jj) * 8;
        const bool in = col < N;
        cs[jj] = in ? *reinterpret_cast<const float2*>(ep.col_scale + col) : make_float2(0.f, 0.f);
        bias[jj] = in ? *reinterpret_cast<const float2*>(ep.bias + col) : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r + 8 * h;
          res[jj][h] = ep.residual != nullptr && row < M && in
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
          if (row >= M || col >= N) continue;
          const int i = 4 * (j0 + jj) + 2 * h;
          const float v0 = ep.col_first ? finish<kAct>(acc[i], cs[jj].x, rs[h], bias[jj].x)
                                        : finish<kAct>(acc[i], rs[h], cs[jj].x, bias[jj].x);
          const float v1 = ep.col_first ? finish<kAct>(acc[i + 1], cs[jj].y, rs[h], bias[jj].y)
                                        : finish<kAct>(acc[i + 1], rs[h], cs[jj].y, bias[jj].y);
          const size_t o = static_cast<size_t>(row) * N + col;
          if (ep.out_f32 != nullptr) {
            *reinterpret_cast<float2*>(ep.out_f32 + o) = make_float2(v0, v1);
          } else {
            __nv_bfloat162 y = __floats2bfloat162_rn(v0, v1);
            if (ep.residual != nullptr)
              y = __floats2bfloat162_rn(__bfloat162float(res[jj][h].x) + __bfloat162float(y.x),
                                        __bfloat162float(res[jj][h].y) + __bfloat162float(y.y));
            *reinterpret_cast<__nv_bfloat162*>(ep.out_bf16 + o) = y;
          }
        }
      }
    }
  }
}

int sms[64];  // the SMs of each device whose shared-memory limits are raised (prepare_device)

}  // namespace

// y [M, N] = act(float(xq . wq^T) * scales + bias), fp32 into y_f32 or rounded
// to bf16 (+ res) into y_bf16. xq [M, K], wq [N, K] int8; K % 16 == 0, N % 8
// == 0.
extern "C" int vt_gemm_i8(const void* xq, const void* row_scale, const void* wq,
                          const void* col_scale, const void* bias, const void* res, void* y_f32,
                          void* y_bf16, int M, int N, int K, int act, int col_first,
                          void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 16 != 0 || N % 8 != 0 || act < kNone || act > kGelu ||
      (y_f32 == nullptr) == (y_bf16 == nullptr) || (res != nullptr && y_bf16 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int slots = kBlocksPerSM * prepare_device(sms, kSmemBytes, gemm_i8_kernel<kNone>,
                                                  gemm_i8_kernel<kQuickGelu>, gemm_i8_kernel<kGelu>);
  if (slots <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  CUtensorMap map_x, map_w;
  if (!make_map(&map_x, xq, M, K, BM, CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !make_map(&map_w, wq, N, K, BN, CU_TENSOR_MAP_DATA_TYPE_UINT8))
    return static_cast<int>(cudaErrorNotSupported);
  const Epilogue ep{static_cast<const float*>(row_scale), static_cast<const float*>(col_scale),
                    static_cast<const float*>(bias), col_first, static_cast<float*>(y_f32),
                    static_cast<__nv_bfloat16*>(y_bf16), static_cast<const __nv_bfloat16*>(res)};
  const long long total = static_cast<long long>((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  const dim3 grid(static_cast<unsigned>(total < slots ? total : slots));
  const auto kernel = act == kQuickGelu ? gemm_i8_kernel<kQuickGelu>
                      : act == kGelu    ? gemm_i8_kernel<kGelu>
                                        : gemm_i8_kernel<kNone>;
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(map_x, map_w, ep, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
