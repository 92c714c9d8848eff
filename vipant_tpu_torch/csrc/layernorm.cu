// layernorm_fwd / layernorm_bwd: the LayerNorm prologue of both fused
// transformer sub-blocks, and its backward with the residual grad.
//
// Replaces: the `_ln_fwd` step (vipant_tpu/ops/fused_attn.py:64) inside the
// Pallas kernels
//   vipant_tpu/ops/fused_attn.py::_fwd_kernel (line 98) and
//   vipant_tpu/ops/fused_mlp.py::_fwd_kernel (line 53), and the LayerNorm
// backward of their backward kernels
//   vipant_tpu/ops/fused_attn.py::_bwd_kernel (lines 234-247) and
//   vipant_tpu/ops/fused_mlp.py::_bwd_kernel (lines 86-94).
// On the TPU the normalised rows never left VMEM and the weight and bias
// grads were summed over the sequential grid; here the normalised rows make
// one bf16 round trip through device memory, because the product that
// follows is a separate kernel (gemm_fwd.cu), and the grads are summed in two
// deterministic stages.
//
// Bound: memory. The forward reads a row of C bf16 values once and writes it
// once (at C = 512 or 768 a few operations per byte); the backward reads x,
// the fp32 dh and the residual grad, and writes dx.
//
// Design, forward: one warp per row, the row held in registers. Each lane
// loads its share of the row as 16-byte vectors (8 bf16; lane l takes
// vectors l, l + 32, ...; kVecs of them, a template parameter, so the row
// stays in registers), all issued before any arithmetic, and the warp's next
// row is loaded while this one is reduced and written. The statistics come
// from the registers through rows.cuh's `warp_row_stats`, shuffles only: no
// shared memory, no barrier. Rounding order as `_ln_fwd`: fp32 two-pass
// statistics, eps before rsqrt, the affine result rounded to bf16 once; only
// the summation order of the two means differs from a serial sum, and it is
// fixed (each lane in order, then an xor butterfly). w and b are read as
// float4 once per warp and kept in registers across the rows it walks. The
// grid is persistent: as many 4-warp blocks as the card holds at once (or
// fewer, for fewer rows), each warp walking rows with the grid's stride. The
// row is read once and written once, in 16-byte stores.
//
// Backward: one block of 256 threads per `rows_per_block` rows. For each row
// every warp recomputes the statistics with `warp_row_stats` (so xhat is
// bitwise the forward's), then the block forms
// dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) with
// dxhat = dh * w, adds the residual grad in fp32 and rounds once; each thread
// keeps its columns' running sums of dh * xhat and dh in shared memory,
// written as the block's partial row, and `sum_partials` adds the partial
// rows in order, one thread per column.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

using rows::block_sum;
using rows::kThreads;
using rows::ln_affine;
using rows::ln_xhat;

constexpr int kFwdWarps = 4;  // warps a block of layernorm_fwd, each owning one row at a time

template <int kVecs>
__global__ void __launch_bounds__(kFwdWarps * 32)
layernorm_fwd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, __nv_bfloat16* __restrict__ y, long long n_rows,
                     int C, float eps) {
  const int lane = threadIdx.x & 31, nv = C >> 3;
  float wl[kVecs][8], bl[kVecs][8];  // w and b of this lane's columns
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int j = lane + 32 * i;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* w4 = reinterpret_cast<const float4*>(w) + 2 * j;
    const float4* b4 = reinterpret_cast<const float4*>(b) + 2 * j;
    const float4 w0 = j < nv ? w4[0] : z, w1 = j < nv ? w4[1] : z;
    const float4 b0 = j < nv ? b4[0] : z, b1 = j < nv ? b4[1] : z;
    const float wa[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const float ba[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) wl[i][k] = wa[k], bl[i][k] = ba[k];
  }
  const long long stride = static_cast<long long>(gridDim.x) * kFwdWarps;
  long long row = static_cast<long long>(blockIdx.x) * kFwdWarps + (threadIdx.x >> 5);
  uint4 v[kVecs];
  rows::load_row(x + row * C, C, lane, row < n_rows, v);
  for (; row < n_rows; row += stride) {
    uint4 next[kVecs];  // the warp's next row, in flight while this one is reduced
    rows::load_row(x + (row + stride) * C, C, lane, row + stride < n_rows, next);
    const float2 st = rows::warp_row_stats(v, C, lane, eps);
    uint4* yr = reinterpret_cast<uint4*>(y + row * C);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int j = lane + 32 * i;
      if (j < nv) {
        float f[8];
        rows::unpack8(v[i], f);
        unsigned u[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          u[k] = rows::pack2(ln_affine(f[2 * k], st, wl[i][2 * k], bl[i][2 * k]),
                             ln_affine(f[2 * k + 1], st, wl[i][2 * k + 1], bl[i][2 * k + 1]));
        yr[j] = make_uint4(u[0], u[1], u[2], u[3]);
      }
      v[i] = next[i];
    }
  }
}

// blocks of `kernel` (`threads` a block, no dynamic shared memory) that the
// current device holds at once: its SMs times the blocks an SM takes; cached
// per device in `slots`, -1 on failure
template <typename Kernel>
inline int resident_blocks(int (&slots)[64], Kernel kernel, int threads) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  if (slots[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0) != cudaSuccess ||
        per_sm <= 0)
      return -1;
    slots[dev] = sms * per_sm;
  }
  return slots[dev];
}

template <int kVecs>
cudaError_t launch_fwd(const void* x, const void* w, const void* b, void* y, long long n_rows, int C,
                       float eps, cudaStream_t s) {
  static int slots[64];
  const int cap = resident_blocks(slots, layernorm_fwd_kernel<kVecs>, kFwdWarps * 32);
  if (cap < 0) return cudaErrorInvalidDevice;
  const long long need = (n_rows + kFwdWarps - 1) / kFwdWarps;
  const unsigned grid = static_cast<unsigned>(need < cap ? need : cap);
  layernorm_fwd_kernel<kVecs><<<grid, kFwdWarps * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y), n_rows, C, eps);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads)
layernorm_bwd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ dh, const __nv_bfloat16* __restrict__ res,
                     __nv_bfloat16* __restrict__ dx, float* __restrict__ partial, long long n_rows,
                     int C, int rows_per_block, float eps) {
  extern __shared__ float sums[];  // [2C]: this block's sums of dh * xhat, then of dh
  __shared__ float red[32];
  for (int c = threadIdx.x; c < 2 * C; c += kThreads) sums[c] = 0.f;
  __syncthreads();  // sums[C + c] is zeroed by another thread than the one that adds to it
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = r0 + rows_per_block < n_rows ? r0 + rows_per_block : n_rows;
  for (long long row = r0; row < r1; ++row) {
    const __nv_bfloat16* xr = x + row * C;
    const float* dhr = dh + row * C;
    const float2 st = rows::warp_row_stats(xr, C, eps);
    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const float xhat = ln_xhat(__bfloat162float(xr[c]), st);
      const float g = dhr[c];
      const float dxhat = g * w[c];
      sums[c] += g * xhat;
      sums[C + c] += g;
      s1 += dxhat;
      s2 += dxhat * xhat;
    }
    const float m1 = block_sum(s1, red) / static_cast<float>(C);
    const float m2 = block_sum(s2, red) / static_cast<float>(C);
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const float xhat = ln_xhat(__bfloat162float(xr[c]), st);
      float v = st.y * (dhr[c] * w[c] - m1 - xhat * m2);
      if (res != nullptr) v += __bfloat162float(res[row * C + c]);
      dx[row * C + c] = __float2bfloat16(v);
    }
  }
  // the block_sum barriers of the last row ordered every write of `sums`
  for (int c = threadIdx.x; c < 2 * C; c += kThreads)
    partial[static_cast<size_t>(blockIdx.x) * 2 * C + c] = sums[c];
}

// out[col] = the partial rows' sums at col, added in order, one thread a column
__global__ void sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                    int chunks, int cols) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[static_cast<size_t>(c) * cols + col];
  out[col] = s;
}

}  // namespace

// y [rows, C] bf16 = LayerNorm(x [rows, C] bf16) * w + b; C % 8 == 0,
// C <= 2048, x, w and b 16-byte aligned (checked by the wrapper)
extern "C" int vt_layernorm_fwd(const void* x, const void* w, const void* b, void* y,
                                long long n_rows, int C, float eps, void* stream) {
  if (n_rows <= 0) return 0;
  if (C <= 0 || C % 8 != 0 || C > rows::kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((C + 255) / 256) {  // 16-byte vectors a lane holds
    case 1: return static_cast<int>(launch_fwd<1>(x, w, b, y, n_rows, C, eps, s));
    case 2: return static_cast<int>(launch_fwd<2>(x, w, b, y, n_rows, C, eps, s));
    case 3: return static_cast<int>(launch_fwd<3>(x, w, b, y, n_rows, C, eps, s));
    case 4: return static_cast<int>(launch_fwd<4>(x, w, b, y, n_rows, C, eps, s));
    case 5: return static_cast<int>(launch_fwd<5>(x, w, b, y, n_rows, C, eps, s));
    case 6: return static_cast<int>(launch_fwd<6>(x, w, b, y, n_rows, C, eps, s));
    case 7: return static_cast<int>(launch_fwd<7>(x, w, b, y, n_rows, C, eps, s));
    default: return static_cast<int>(launch_fwd<8>(x, w, b, y, n_rows, C, eps, s));
  }
}

// dx [rows, C] bf16; partial: [ceil(rows / rows_per_block), 2C] fp32
// scratch; dwb: [2C] fp32 receiving the weight grad, then the bias grad;
// the same contract on C and alignment as vt_layernorm_fwd
extern "C" int vt_layernorm_bwd(const void* x, const void* w, const void* dh, const void* res,
                                void* dx, void* partial, void* dwb, long long n_rows, int C,
                                int rows_per_block, float eps, void* stream) {
  if (C <= 0) return 0;
  if (C % 8 != 0 || C > rows::kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = static_cast<int>((n_rows + rows_per_block - 1) / rows_per_block);
  const int smem = 2 * C * static_cast<int>(sizeof(float));
  if (chunks > 0) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          layernorm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    layernorm_bwd_kernel<<<chunks, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<const float*>(dh), static_cast<const __nv_bfloat16*>(res),
        static_cast<__nv_bfloat16*>(dx), static_cast<float*>(partial), n_rows, C, rows_per_block,
        eps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sum_partials_kernel<<<(2 * C + 255) / 256, 256, 0, s>>>(static_cast<const float*>(partial),
                                                          static_cast<float*>(dwb), chunks, 2 * C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
