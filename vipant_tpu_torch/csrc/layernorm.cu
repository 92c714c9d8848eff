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
// the fp32 dh and the residual grad, and writes dx: 8 bytes an element in,
// 2 out (150 MB at the training step's [19,584, 768], a 45 us bound).
//
// Design, forward: one warp per row, the row held in registers. Each lane
// loads its share of the row as 16-byte vectors (8 bf16; lane l takes
// vectors l, l + 32, ...; kVecs of them, a template parameter, so the row
// stays in registers), all issued before any arithmetic, and the warp's next
// row is loaded while this one is reduced and written. The statistics come
// from the registers through rows.cuh's `warp_row_stats`, shuffles only: no
// shared memory, no barrier. Rounding order as `_ln_fwd`: two-pass
// statistics, eps before the square root, the affine result rounded to bf16
// once; the statistics are summed in float64 in a fixed order (each lane in
// order, then an xor butterfly) and rounded to fp32 once, so they are the
// plain version's (rows.cuh says when they could differ). w and b are read as
// float4 once per warp and kept in registers across the rows it walks. The
// grid is persistent: as many 4-warp blocks as the card holds at once (or
// fewer, for fewer rows), each warp walking rows with the grid's stride. The
// row is read once and written once, in 16-byte stores.
//
// Backward: the same shape. A warp per row on a persistent grid planned on
// the host (kernels.layernorm_bwd_split: as many 4-warp blocks as the card
// holds at once, warp gw walking rows gw * R .. gw * R + R - 1 in order, so
// the order of every sum is a function of the shapes). A lane holds its
// vectors of x and of the residual grad (16 bytes, 8 bf16) and of dh (8 fp32,
// two 16-byte loads) in registers, and at the paths' widths (C <= 768) the
// warp's next row is in flight while this one is reduced. The statistics
// are `warp_row_stats` of the registers, so xhat is bitwise the forward's;
// the two means, of dxhat = dh * w and of dxhat * xhat, are xor butterflies:
// no shared memory, no barrier in the row loop. dx = rstd * (dxhat -
// mean(dxhat) - xhat * mean(dxhat * xhat)) plus the residual grad in fp32,
// rounded once, goes out in 16-byte stores. w is read once per block into
// shared memory. A lane owns the same columns on every row its warp walks,
// so it keeps their running sums of dh * xhat and dh in registers across
// its rows (in row order); at the end the block's warps add theirs in warp
// order into one partial row per block, and reduce.cu's colsum adds the few
// hundred partial rows in its fixed order (kernels.colsum_split). No
// atomics: dw and db are the same bits in every run, db bitwise
// kernels.layernorm_bwd_ordered's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

using rows::ln_affine;

constexpr int kFwdWarps = 4;  // warps a block of layernorm_fwd, each owning one row at a time
constexpr int kBwdWarps = 4;  // warps a block of layernorm_bwd (kernels.LN_BWD_WARPS), each walking its own rows

template <int kVecs>
__global__ void __launch_bounds__(kFwdWarps * 32)
layernorm_fwd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, __nv_bfloat16* __restrict__ y, long long n_rows,
                     int C, float eps) {
  const int lane = threadIdx.x & 31, nv = C >> 3;
  float wl[kVecs][8], bl[kVecs][8];  // w and b of this lane's columns
  rows::load_affine(w, b, C, lane, wl, bl);
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

template <int kVecs>
cudaError_t launch_fwd(const void* x, const void* w, const void* b, void* y, long long n_rows, int C,
                       float eps, cudaStream_t s) {
  static int slots[64];
  const int cap = rows::resident_blocks(slots, layernorm_fwd_kernel<kVecs>, kFwdWarps * 32);
  if (cap < 0) return cudaErrorInvalidDevice;
  const long long need = (n_rows + kFwdWarps - 1) / kFwdWarps;
  const unsigned grid = static_cast<unsigned>(need < cap ? need : cap);
  layernorm_fwd_kernel<kVecs><<<grid, kFwdWarps * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y), n_rows, C, eps);
  return cudaGetLastError();
}

// layernorm_bwd's schedule by width (kVecs 16-byte vectors a lane holds):
// whether the warp's next row is loaded while this one is reduced, whether
// the weight-grad sums stay in registers, and the blocks an SM holds at once
// (the register budget; kernels.layernorm_bwd_split plans its grid with the
// same numbers). Up to kVecs = 3 (C <= 768, every path's width) x, dh, the
// residual, the next row's and the sums all stay in registers; wider rows
// drop the prefetch, and past kVecs = 5 the sums go to the warp's own
// columns of shared memory, or they would spill.
template <int kVecs>
struct BwdSchedule {
  static constexpr bool kPrefetch = kVecs <= 3;
  static constexpr bool kRegisterSums = kVecs <= 5;
  static constexpr int kBlocksPerSM = kVecs <= 2 ? 4 : kVecs <= 4 ? 3 : 2;
};

// a lane's running sums of dh * xhat and dh over the rows its warp walks,
// for its columns 8 j + k, j = lane + 32 i: in registers, or in `mine`, the
// warp's [2C] row of shared memory (each lane touches only its columns)
template <int kVecs, bool kRegisters>
struct BwdSums {
  float dw[kVecs][8], db[kVecs][8];
  __device__ __forceinline__ BwdSums(float*, int, int) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) dw[i][k] = db[i][k] = 0.f;
  }
  __device__ __forceinline__ void add(int i, int, int k, float g, float xhat) {
    dw[i][k] = __fadd_rn(dw[i][k], __fmul_rn(g, xhat));
    db[i][k] = __fadd_rn(db[i][k], g);
  }
  // into `mine` at the end, for the block's reduction
  __device__ __forceinline__ void store(float* mine, int C, int lane) const {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int j = lane + 32 * i;
      if (j < (C >> 3)) {
        float4* dw4 = reinterpret_cast<float4*>(mine + 8 * j);
        float4* db4 = reinterpret_cast<float4*>(mine + C + 8 * j);
        dw4[0] = make_float4(dw[i][0], dw[i][1], dw[i][2], dw[i][3]);
        dw4[1] = make_float4(dw[i][4], dw[i][5], dw[i][6], dw[i][7]);
        db4[0] = make_float4(db[i][0], db[i][1], db[i][2], db[i][3]);
        db4[1] = make_float4(db[i][4], db[i][5], db[i][6], db[i][7]);
      }
    }
  }
};

template <int kVecs>
struct BwdSums<kVecs, false> {
  float* mine;
  int C;
  __device__ __forceinline__ BwdSums(float* m, int c, int lane) : mine(m), C(c) {
    for (int j = lane; j < (C >> 3); j += 32)
#pragma unroll
      for (int k = 0; k < 8; ++k) mine[8 * j + k] = mine[C + 8 * j + k] = 0.f;
  }
  __device__ __forceinline__ void add(int, int j, int k, float g, float xhat) {
    mine[8 * j + k] = __fadd_rn(mine[8 * j + k], __fmul_rn(g, xhat));
    mine[C + 8 * j + k] = __fadd_rn(mine[C + 8 * j + k], g);
  }
  __device__ __forceinline__ void store(float*, int, int) const {}
};

// one row of the backward's inputs in a lane's registers: x and the
// residual grad as 8 bf16 a vector, dh as 8 fp32 (two 16-byte halves)
template <int kVecs>
struct BwdRow {
  uint4 x[kVecs], r[kVecs];
  float4 g[kVecs][2];

  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ xr,
                                       const float* __restrict__ gr,
                                       const __nv_bfloat16* __restrict__ rr, int C, int lane,
                                       bool valid) {
    rows::load_row(xr, C, lane, valid, x);
    rows::load_row(rr, C, lane, valid && rr != nullptr, r);
    const float4* g4 = reinterpret_cast<const float4*>(gr);
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int j = lane + 32 * i;
      const bool in = valid && j < (C >> 3);
      g[i][0] = in ? g4[2 * j] : z;
      g[i][1] = in ? g4[2 * j + 1] : z;
    }
  }
};

__device__ __forceinline__ void unpack_f8(const float4 (&h)[2], float (&f)[8]) {
  f[0] = h[0].x, f[1] = h[0].y, f[2] = h[0].z, f[3] = h[0].w;
  f[4] = h[1].x, f[5] = h[1].y, f[6] = h[1].z, f[7] = h[1].w;
}

// Rows [gw * rows_per_warp, (gw + 1) * rows_per_warp) of x, dh and res for
// warp gw = blockIdx.x * kBwdWarps + warp, in order; dx of each row, and the
// block's weight-grad partial row: partial[blockIdx.x] = [sum dh * xhat, sum
// dh] over the block's rows, each warp's sums added in row order, the warps'
// in warp order.
template <int kVecs>
__global__ void __launch_bounds__(kBwdWarps * 32, BwdSchedule<kVecs>::kBlocksPerSM)
layernorm_bwd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ dh, const __nv_bfloat16* __restrict__ res,
                     __nv_bfloat16* __restrict__ dx, float* __restrict__ partial, long long n_rows,
                     int C, int rows_per_warp, float eps) {
  extern __shared__ __align__(16) float smem[];  // w [C], then each warp's sums [kBwdWarps][2C]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nv = C >> 3;
  for (int c = 4 * threadIdx.x; c < C; c += 4 * kBwdWarps * 32)
    *reinterpret_cast<float4*>(smem + c) = *reinterpret_cast<const float4*>(w + c);
  __syncthreads();
  const float4* w4 = reinterpret_cast<const float4*>(smem);

  float* mine = smem + C + warp * 2 * C;
  BwdSums<kVecs, BwdSchedule<kVecs>::kRegisterSums> sums(mine, C, lane);

  const long long r0 = (static_cast<long long>(blockIdx.x) * kBwdWarps + warp) * rows_per_warp;
  const long long r1 = r0 + rows_per_warp < n_rows ? r0 + rows_per_warp : n_rows;
  BwdRow<kVecs> cur;
  if constexpr (BwdSchedule<kVecs>::kPrefetch)
    cur.load(x + r0 * C, dh + r0 * C, res ? res + r0 * C : nullptr, C, lane, r0 < r1);
  for (long long row = r0; row < r1; ++row) {
    BwdRow<kVecs> next;  // the warp's next row, in flight while this one is reduced
    if constexpr (BwdSchedule<kVecs>::kPrefetch) {
      const long long rn = row + 1;
      next.load(x + rn * C, dh + rn * C, res ? res + rn * C : nullptr, C, lane, rn < r1);
    } else {
      cur.load(x + row * C, dh + row * C, res ? res + row * C : nullptr, C, lane, true);
    }
    const float2 st = rows::warp_row_stats(cur.x, C, lane, eps);  // the forward's bits
    // dxhat = dh * w; the two row means of dxhat and dxhat * xhat
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int j = lane + 32 * i;
      if (j < nv) {
        float f[8], g[8], wv[8];
        rows::unpack8(cur.x[i], f);
        unpack_f8(cur.g[i], g);
        const float4 wh[2] = {w4[2 * j], w4[2 * j + 1]};
        unpack_f8(wh, wv);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float xhat = rows::ln_xhat(f[k], st), dxhat = g[k] * wv[k];
          s1 += dxhat;
          s2 += dxhat * xhat;
          sums.add(i, j, k, g[k], xhat);
        }
      }
    }
    const float m1 = __fdiv_rn(rows::warp_sum(s1), static_cast<float>(C));
    const float m2 = __fdiv_rn(rows::warp_sum(s2), static_cast<float>(C));
    // dx = rstd * (dxhat - m1 - xhat * m2) + residual, rounded once; 16-byte stores
    uint4* dxr = reinterpret_cast<uint4*>(dx + row * C);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int j = lane + 32 * i;
      if (j < nv) {
        float f[8], g[8], wv[8], rv[8];
        rows::unpack8(cur.x[i], f);
        unpack_f8(cur.g[i], g);
        const float4 wh[2] = {w4[2 * j], w4[2 * j + 1]};
        unpack_f8(wh, wv);
        rows::unpack8(cur.r[i], rv);
        unsigned u[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 2 * k + e;
            const float xhat = rows::ln_xhat(f[c], st);
            v[e] = st.y * (g[c] * wv[c] - m1 - xhat * m2) + rv[c];
          }
          u[k] = rows::pack2(__float2bfloat16(v[0]), __float2bfloat16(v[1]));
        }
        dxr[j] = make_uint4(u[0], u[1], u[2], u[3]);
      }
    }
    if constexpr (BwdSchedule<kVecs>::kPrefetch) cur = next;
  }

  // the block's partial row: the warps' sums through shared memory, added in warp order
  sums.store(mine, C, lane);
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * C; c += kBwdWarps * 32) {
    float t = smem[C + c];
#pragma unroll
    for (int v = 1; v < kBwdWarps; ++v) t = __fadd_rn(t, smem[C + v * 2 * C + c]);
    partial[static_cast<size_t>(blockIdx.x) * 2 * C + c] = t;
  }
}

template <int kVecs>
cudaError_t launch_bwd(const void* x, const void* w, const void* dh, const void* res, void* dx,
                       void* partial, long long n_rows, int C, int rows_per_warp, int blocks,
                       float eps, cudaStream_t s) {
  const int smem = (1 + 2 * kBwdWarps) * C * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        layernorm_bwd_kernel<kVecs>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  layernorm_bwd_kernel<kVecs><<<blocks, kBwdWarps * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(dh), static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(partial), n_rows, C, rows_per_warp, eps);
  return cudaGetLastError();
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

// the ordered column sums of reduce.cu, which add the block partials
extern "C" int vt_colsum(const void* x, int is_f32, void* partial, void* out, long long n_rows,
                         int N, int chunks, int rows_per_chunk, void* stream);

// dx [rows, C] bf16 = the LayerNorm backward of x for the fp32 output grad
// dh, plus the residual grad res (or null); dwb [2C] fp32 = the weight grad,
// then the bias grad. The plan (kernels.layernorm_bwd_split): `blocks`
// blocks of kBwdWarps warps, warp gw taking rows [gw * rows_per_warp, ...);
// partial [blocks, 2C] fp32 scratch for the blocks' sums, which colsum adds
// in `cs_chunks` chunks of `cs_rows` (kernels.colsum_split(blocks, 2C, 4))
// through cs_partial [cs_chunks, 2C]. The same contract on C and alignment
// as vt_layernorm_fwd.
extern "C" int vt_layernorm_bwd(const void* x, const void* w, const void* dh, const void* res,
                                void* dx, void* partial, void* cs_partial, void* dwb,
                                long long n_rows, int C, int rows_per_warp, int blocks,
                                int cs_chunks, int cs_rows, float eps, void* stream) {
  if (n_rows <= 0 || blocks <= 0 || rows_per_warp <= 0 ||
      static_cast<long long>(blocks) * kBwdWarps * rows_per_warp < n_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C <= 0 || C % 8 != 0 || C > rows::kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((C + 255) / 256) {  // 16-byte vectors a lane holds
    case 1: err = launch_bwd<1>(x, w, dh, res, dx, partial, n_rows, C, rows_per_warp, blocks, eps, s); break;
    case 2: err = launch_bwd<2>(x, w, dh, res, dx, partial, n_rows, C, rows_per_warp, blocks, eps, s); break;
    case 3: err = launch_bwd<3>(x, w, dh, res, dx, partial, n_rows, C, rows_per_warp, blocks, eps, s); break;
    case 4: err = launch_bwd<4>(x, w, dh, res, dx, partial, n_rows, C, rows_per_warp, blocks, eps, s); break;
    case 5: err = launch_bwd<5>(x, w, dh, res, dx, partial, n_rows, C, rows_per_warp, blocks, eps, s); break;
    case 6: err = launch_bwd<6>(x, w, dh, res, dx, partial, n_rows, C, rows_per_warp, blocks, eps, s); break;
    case 7: err = launch_bwd<7>(x, w, dh, res, dx, partial, n_rows, C, rows_per_warp, blocks, eps, s); break;
    default: err = launch_bwd<8>(x, w, dh, res, dx, partial, n_rows, C, rows_per_warp, blocks, eps, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return vt_colsum(partial, 1, cs_partial, dwb, blocks, 2 * C, cs_chunks, cs_rows, stream);
}

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
