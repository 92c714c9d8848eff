// Tiles and helpers shared by attention.cu (forward), attention_bwd.cu and
// flash_attention.cu.
//
// In attention.cu and attention_bwd.cu q, k and v are the three C-wide sections of each row of the packed
// [B, T, 3C] projection, and head h occupies columns [h*64, h*64+64) of each
// section (torch MultiheadAttention's order). In attention_bwd.cu and
// flash_attention.cu a block owns 64 query rows (or 64 keys), 4 warps of 16
// rows each, and streams the other side through shared memory in tiles of
// 64, its scores passing through an fp32 tile in shared memory
// (`score_tile`). attention.cu's forward owns 128 query rows and keeps its
// scores in registers; it shares the tile shapes, `scaled` and `prob`. Rows
// past T are zero-filled.
//
// Both backward kernels compute a score tile with the same `score_tile` on
// the same (query tile, key tile) pair; the forward runs the same
// tensor-core instruction (`wmma` 16x16x16 bf16 is two `mma.sync.m16n8k16`)
// over the same four steps of the head dim from a zero accumulator, and all
// three scale and bias the raw score with the same `scaled` and normalise it
// with the same `prob`, so the backward's recomputed probabilities are meant
// to be bitwise the forward's. Nothing is gated on that: the gradients are
// held to the plain versions and to fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace attn {

using namespace nvcuda;

constexpr int D = 64;         // head dim (checked by the wrappers)
constexpr int BQ = 64;        // query rows per tile: 4 warps x 16
constexpr int BKV = 64;       // keys per tile
constexpr int LDH = D + 8;    // bf16 tile row: 144 bytes
constexpr int LDS = BKV + 4;  // fp32 score row: 272 bytes
constexpr int kThreads = 128;
constexpr int kTileBytes = BQ * LDH * 2;  // one bf16 64 x 72 tile
constexpr int kScoreBytes = BQ * LDS * 4;  // one fp32 64 x 68 tile

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// rows [r0, r0 + 64) of one head's 64 columns (row stride `ld`) into a
// 64 x LDH tile; rows past T are zero
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* base, int r0,
                                          int T, int ld) {
  for (int c = threadIdx.x; c < 64 * (D / 8); c += kThreads) {
    const int r = c >> 3, k = (c & 7) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T) v = *reinterpret_cast<const uint4*>(base + static_cast<size_t>(r0 + r) * ld + k);
    *reinterpret_cast<uint4*>(dst + r * LDH + k) = v;
  }
}

// fp32 A . B^T for this warp's 16 rows of the 64 x 64 tile A against the 64
// rows of B, stored to the warp's rows of S (q.k^T for scores, do.v^T for dp)
__device__ __forceinline__ void score_tile(const __nv_bfloat16* As, const __nv_bfloat16* Bs,
                                           float* Ss, int warp) {
  FragC s[BKV / 16];
#pragma unroll
  for (int j = 0; j < BKV / 16; ++j) wmma::fill_fragment(s[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, As + warp * 16 * LDH + kk, LDH);
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) {
      FragBc b;
      wmma::load_matrix_sync(b, Bs + j * 16 * LDH + kk, LDH);
      wmma::mma_sync(s[j], a, b, s[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BKV / 16; ++j)
    wmma::store_matrix_sync(Ss + warp * 16 * LDS + j * 16, s[j], LDS, wmma::mem_row_major);
  __syncwarp();
}

// the Pallas order: (q.k) * scale, then + bias, each rounded in fp32; the
// bias is [Tq, Tk] (flash_attention.cu: queries and keys of different length)
__device__ __forceinline__ float scaled(float raw, float scale, const float* bias, int i, int j,
                                        int Tq, int Tk) {
  const float bv = (bias != nullptr && i < Tq) ? bias[static_cast<size_t>(i) * Tk + j] : 0.f;
  return __fadd_rn(__fmul_rn(raw, scale), bv);
}

// the same for self-attention's [T, T] bias
__device__ __forceinline__ float scaled(float raw, float scale, const float* bias, int i, int j,
                                        int T) {
  return scaled(raw, scale, bias, i, j, T, T);
}

// exp(x) for x <= 0 as one multiply and the hardware's base-2 exponential
// (about 2 ulp; the plain versions' exp differs from it far below the bf16
// rounding that follows)
__device__ __forceinline__ float exp_fast(float x) { return __expf(x); }

// the normalised probability from the forward's row max m and the reciprocal
// of its row sum l
__device__ __forceinline__ float prob(float s, float m, float inv_l) {
  return __fmul_rn(exp_fast(s - m), inv_l);
}

}  // namespace attn
