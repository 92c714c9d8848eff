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
// Bound: tensor-core operations at the slice's shapes (M = B*T in the
// thousands, N and K in 512..3072). This first version issues warp-level
// `mma.sync.m16n8k32` (s8 x s8 -> s32), not Hopper's `wgmma`, through a
// two-stage cp.async ring, so it reaches only a share of the card's int8
// peak.
//
// Design: a block computes a 128x128 tile of Y with 8 warps (2 x 4, 64x32
// each: 4 x 4 mma tiles, 64 int32 accumulators a thread), walking K in steps
// of 64 bytes. Both operands are K-contiguous, staged [128][64 + 16] bytes:
// the 80-byte row pitch puts the eight rows a warp reads at once on distinct
// banks, so every fragment register is one conflict-free 4-byte shared load
// and nothing is transposed. Rows past M, columns past N and steps past K
// are zero-filled on load (K % 16 == 0, so a 16-byte chunk is wholly in or
// out) and masked on store: M = B*T is ragged.
//
// The int32 sum is exact. Epilogue, in the Pallas order, every step one fp32
// rounding (no fused multiply-add): convert the sum to fp32; times the row
// scale, then the column scale (or the column scale first: the qkv projection
// of _fwd_int8_kernel multiplies in that order); plus bias; the activation;
// then an fp32 store, or one bf16 rounding after which the residual is added
// in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64;  // BK in int8 elements = bytes
constexpr int LD = BK + 16;                 // staged row pitch: 80 bytes
constexpr int kThreads = 256;
constexpr int WM = 64, WN = 32;           // warp tile
constexpr int FM = WM / 16, FN = WN / 8;  // 4 x 4 mma tiles (m16n8) per warp
constexpr int kStageBytes = BM * LD;

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

// Stage rows [row0, row0 + 128) x bytes [k0, k0 + 64) of a [rows, K] int8
// operand: 512 chunks of 16 bytes, two per thread.
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src, int row0, int rows,
                                          int k0, int K) {
#pragma unroll
  for (int i = 0; i < (BM * BK / 16) / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 2, kc = (c & 3) * 16;
    const int gr = row0 + r, gk = k0 + kc;
    const bool in = gr < rows && gk < K;
    const int8_t* g = in ? src + static_cast<size_t>(gr) * K + gk : src;
    cp_async16(dst + r * LD + kc, g, in);
  }
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D = A . B + D for one m16n8k32 tile: A row-major [16, 32], B col-major
// [32, 8] (both K-contiguous), int8 in, int32 out
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float act_fwd(float v, int act) {
  if (act == kQuickGelu) return v * (1.f / (1.f + expf(-1.702f * v)));
  if (act == kGelu) return v * (erff(v * 0.70710678118654752f) + 1.f) * 0.5f;
  return v;
}

struct Epilogue {
  const float* row_scale;         // [M]
  const float* col_scale;         // [N]
  const float* bias;              // [N]
  int col_first;                  // multiply by the column scale before the row scale
  int act;
  float* out_f32;                 // [M, N] fp32 result or null
  __nv_bfloat16* out_bf16;        // [M, N] bf16 result or null
  const __nv_bfloat16* residual;  // added after the bf16 rounding, or null
};

__device__ __forceinline__ float finish(int sum, float rs, float cs, float bias,
                                        const Epilogue& ep) {
  const float v = __int2float_rn(sum);
  const float d = ep.col_first ? __fmul_rn(__fmul_rn(v, cs), rs) : __fmul_rn(__fmul_rn(v, rs), cs);
  return act_fwd(__fadd_rn(d, bias), ep.act);
}

// two neighbouring columns (gn, gn + 1) of row gm; N is even, so both are in
__device__ __forceinline__ void store_pair(const Epilogue& ep, size_t o, float v0, float v1) {
  if (ep.out_f32 != nullptr) *reinterpret_cast<float2*>(ep.out_f32 + o) = make_float2(v0, v1);
  if (ep.out_bf16 != nullptr) {
    __nv_bfloat16 y0 = __float2bfloat16(v0), y1 = __float2bfloat16(v1);
    if (ep.residual != nullptr) {
      const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(ep.residual + o);
      y0 = __float2bfloat16(__bfloat162float(r.x) + __bfloat162float(y0));
      y1 = __float2bfloat16(__bfloat162float(r.y) + __bfloat162float(y1));
    }
    __nv_bfloat162 y;
    y.x = y0;
    y.y = y1;
    *reinterpret_cast<__nv_bfloat162*>(ep.out_bf16 + o) = y;
  }
}

__global__ void __launch_bounds__(kThreads)
gemm_i8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B, int M, int N, int K,
               Epilogue ep) {
  __shared__ __align__(128) int8_t As[2][kStageBytes];
  __shared__ __align__(128) int8_t Bs[2][kStageBytes];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;  // the mma fragment's row group and column quad

  int acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (K + BK - 1) / BK;
  load_tile(As[0], A, m0, M, 0, K);
  load_tile(Bs[0], B, n0, N, 0, K);
  cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) {
      load_tile(As[s ^ 1], A, m0, M, (kt + 1) * BK, K);
      load_tile(Bs[s ^ 1], B, n0, N, (kt + 1) * BK, K);
    }
    cp_async_commit();  // possibly empty: keeps "all but the newest group" meaning tile kt
    cp_async_wait_one();
    __syncthreads();

    const int8_t* as = As[s] + (wm * WM + g) * LD + t * 4;
    const int8_t* bs = Bs[s] + (wn * WN + g) * LD + t * 4;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[FM][4], b[FN][2];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int8_t* p = as + i * 16 * LD + kk;
        a[i][0] = lds32(p);                // row g,     k = t*4 ..
        a[i][1] = lds32(p + 8 * LD);       // row g + 8
        a[i][2] = lds32(p + 16);           // row g,     k = 16 + t*4 ..
        a[i][3] = lds32(p + 8 * LD + 16);  // row g + 8
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int8_t* p = bs + j * 8 * LD + kk;
        b[j][0] = lds32(p);       // column g, k = t*4 ..
        b[j][1] = lds32(p + 16);  // column g, k = 16 + t*4 ..
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();  // stage s is refilled by the next iteration's loads
  }

  // Epilogue from the accumulator registers: a thread holds rows g and g + 8
  // and columns 2t, 2t + 1 of each m16n8 tile.
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm * WM + i * 16 + g + h * 8;
      if (gm >= M) continue;
      const float rs = ep.row_scale[gm];
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int gn = n0 + wn * WN + j * 8 + t * 2;
        if (gn >= N) continue;
        const float v0 = finish(acc[i][j][2 * h], rs, ep.col_scale[gn], ep.bias[gn], ep);
        const float v1 =
            finish(acc[i][j][2 * h + 1], rs, ep.col_scale[gn + 1], ep.bias[gn + 1], ep);
        store_pair(ep, static_cast<size_t>(gm) * N + gn, v0, v1);
      }
    }
  }
}

}  // namespace

// y [M, N] = act(float(xq . wq^T) * scales + bias), fp32 into y_f32 or rounded
// to bf16 (+ res) into y_bf16. xq [M, K], wq [N, K] int8; K % 16 == 0, N even.
extern "C" int vt_gemm_i8(const void* xq, const void* row_scale, const void* wq,
                          const void* col_scale, const void* bias, const void* res, void* y_f32,
                          void* y_bf16, int M, int N, int K, int act, int col_first,
                          void* stream) {
  if (M <= 0 || N <= 0) return 0;
  Epilogue ep{static_cast<const float*>(row_scale), static_cast<const float*>(col_scale),
              static_cast<const float*>(bias), col_first, act, static_cast<float*>(y_f32),
              static_cast<__nv_bfloat16*>(y_bf16), static_cast<const __nv_bfloat16*>(res)};
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_i8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq), M, N, K, ep);
  return static_cast<int>(cudaGetLastError());
}
