// Tiles and helpers shared by attention.cu (forward), attention_bwd.cu and
// flash_attention.cu.
//
// In attention.cu and attention_bwd.cu q, k and v are the three C-wide
// sections of each row of the packed [B, T, 3C] projection, and head h
// occupies columns [h*64, h*64+64) of each section (torch
// MultiheadAttention's order). Rows past T are zero-filled.
//
// attention.cu and attention_bwd.cu keep their scores in registers: a warp
// issues `mma.sync.m16n8k16` itself (`scores`, `pv_product` below), so a
// thread knows which (row, column) each accumulator holds. The forward and
// both backward kernels form every score with the same `scores` (the same
// instruction over the same four steps of the head dim, from zero; the dkv
// kernel with keys as the rows, which swaps the two operands of each
// product but not the products or their order), scale and bias it with the
// same `scaled` and normalise it with the same `prob`, so the backward's
// recomputed probabilities are the forward's bit for bit: the GPU tests
// and chip_smoke.py hold p read out of the forward (v one-hot) against p
// read out of the backward's dv (do one-hot).
//
// flash_attention.cu is built from the same register-level pieces
// (`scores`, `fold_stats`, `add_pv` in the forward; `scores` and
// `pv_product` in the backward and the bias grad), with separate query and
// key lengths.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace attn {

constexpr int D = 64;         // head dim (checked by the wrappers)
constexpr int BQ = 64;        // query rows per tile
constexpr int BKV = 64;       // keys per tile
constexpr int LDH = D + 8;    // bf16 tile row: 144 bytes
constexpr int kTileBytes = BQ * LDH * 2;  // one bf16 64 x 72 tile

// the Pallas order: (q.k) * scale, then + bias, each rounded in fp32
__device__ __forceinline__ float scaled(float raw, float scale, float bv) {
  return __fadd_rn(__fmul_rn(raw, scale), bv);
}

// the same with the bias read from [Tq, Tk] (flash_attention.cu: queries and
// keys of different length)
__device__ __forceinline__ float scaled(float raw, float scale, const float* bias, int i, int j,
                                        int Tq, int Tk) {
  return scaled(raw, scale, (bias != nullptr && i < Tq) ? bias[static_cast<size_t>(i) * Tk + j] : 0.f);
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

// ---------------------------------------------------------------------------
// register-level tiles: attention.cu, attention_bwd.cu, flash_attention.cu
// ---------------------------------------------------------------------------

// four 8x8 bf16 matrices, row addresses from lanes 8i .. 8i + 7 for matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, fp32 accumulate. Lane l holds
// d[0..1] at row l / 4, columns 2 (l % 4) + {0, 1}, and d[2..3] at row l / 4 + 8.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows [r0, r0 + nrows) of one head's 64 columns (row stride `ld`) into a
// tile of pitch LDH, asynchronously, by the block's `threads` threads; rows
// past T are zero
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* base, int r0,
                                           int nrows, int T, int ld, int threads) {
  for (int c = threadIdx.x; c < nrows * (D / 8); c += threads) {
    const int r = c >> 3, k = (c & 7) * 8;
    const bool in = r0 + r < T;
    async_copy::cp_async16(dst + r * LDH + k, in ? base + static_cast<size_t>(r0 + r) * ld + k : base,
                           in);
  }
}

// The A fragments (one per 16 of the 64 head dims) of the 16 rows [r0, r0 +
// 16) of one head's columns, straight from device memory (row stride `ld`);
// rows past T are zero. The same registers as `ldmatrix_x4` of a staged tile.
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[4][4], const __nv_bfloat16* base, int r0,
                                             int T, int ld, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + (lane >> 2) + 8 * h;
    const bool in = row < T;
    const uint32_t* p =
        reinterpret_cast<const uint32_t*>(base + static_cast<size_t>(in ? row : 0) * ld + (lane & 3) * 2);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      f[kk][h] = in ? p[kk * 8] : 0u;
      f[kk][2 + h] = in ? p[kk * 8 + 4] : 0u;
    }
  }
}

// The same A fragments of rows [r0, r0 + 16) of a tile staged in shared
// memory (pitch LDH), through `ldmatrix`
__device__ __forceinline__ void tile_a_frags(uint32_t (&f)[4][4], const __nv_bfloat16* tile, int r0,
                                             int lane) {
  // matrix i of a load: rows + 8 (i & 1), head dims + 8 (i >> 1)
  const __nv_bfloat16* row = tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(f[kk], row + kk * 16);
}

// raw fp32 scores of a warp's 16 rows (A fragments af, one per 16 of the 64
// head dims) against kBlocks x 8 rows of tile Bs (pitch LDH): s[j] is the
// 16 x 8 block of rows 8 j .. 8 j + 7 of Bs. Each block sums the head dim
// in the same four steps of 16, from zero, whatever kBlocks is.
template <int kBlocks = BKV / 8>
__device__ __forceinline__ void scores(float (&s)[kBlocks][4], const uint32_t (&af)[4][4],
                                       const __nv_bfloat16* Bs, int lane) {
  const __nv_bfloat16* brow = Bs + (lane & 7) * LDH + (lane >> 3) * 8;
#pragma unroll
  for (int j = 0; j < kBlocks; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    uint32_t bb[4];
    ldmatrix_x4(bb, brow + j * 8 * LDH);  // head dims 0 .. 31 of rows 8 j .. 8 j + 7
    mma_16816(s[j], af[0], bb[0], bb[1]);
    mma_16816(s[j], af[1], bb[2], bb[3]);
    ldmatrix_x4(bb, brow + j * 8 * LDH + 32);
    mma_16816(s[j], af[2], bb[0], bb[1]);
    mma_16816(s[j], af[3], bb[2], bb[3]);
  }
}

// o (16 x 64 fp32) += bf16(p) . V: p is a warp's 16 rows against kBlocks x 8
// rows of tile Vs as `scores` lays them out, rounded to bf16 here and packed
// straight into the A fragments; the rows of Vs (pitch LDH) are the
// reduction, read through the transposing `ldmatrix`
template <int kBlocks = BKV / 8>
__device__ __forceinline__ void pv_product(float (&o)[8][4], const float (&p)[kBlocks][4],
                                           const __nv_bfloat16* Vs, int lane) {
  // matrix i of a transposed load: rows + 8 (i & 1), head dims + 8 (i >> 1)
  const __nv_bfloat16* vrow = Vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDH + (lane >> 4) * 8;
#pragma unroll
  for (int u = 0; u < kBlocks / 2; ++u) {  // rows 16 u .. 16 u + 15 of Vs
    const uint32_t pa[4] = {pack_bf16(p[2 * u][0], p[2 * u][1]), pack_bf16(p[2 * u][2], p[2 * u][3]),
                            pack_bf16(p[2 * u + 1][0], p[2 * u + 1][1]),
                            pack_bf16(p[2 * u + 1][2], p[2 * u + 1][3])};
#pragma unroll
    for (int n = 0; n < 4; ++n) {  // head dims 16 n .. 16 n + 15
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vrow + u * 16 * LDH + n * 16);
      mma_16816(o[2 * n], pa, vb[0], vb[1]);
      mma_16816(o[2 * n + 1], pa, vb[2], vb[3]);
    }
  }
}

// The softmax state of one warp of a forward kernel: 16 query rows, of which
// a lane holds two (lane / 4 and lane / 4 + 8) and, of every 8 keys, the two
// at 2 (lane % 4).
struct Rows {
  int i[2];    // global query index of the lane's two rows
  float m[2];  // running row max
  float l[2];  // running row sum of exp(s - m); its reciprocal in pass 2
};

// pass 1 on one tile of 64 keys starting at k0: scale and bias the raw
// scores `s` in place (keys past Tk: -inf) and fold them into m and l. kTail:
// the tile may hold keys past Tk (only the last tile does). Tq, Tk: the query
// and key lengths, the bias [Tq, Tk] (self-attention: both T).
template <bool kTail>
__device__ __forceinline__ void fold_stats(Rows& rw, float (&s)[8][4], int k0, int lane, int Tq,
                                           int Tk, const float* bias, float scale) {
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
      s[j][e] = !kTail || col < Tk ? scaled(s[j][e], scale, bias, rw.i[e >> 1], col, Tq, Tk) : -INFINITY;
      tmax[e >> 1] = fmaxf(tmax[e >> 1], s[j][e]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mnew = fmaxf(rw.m[h], quad_max(tmax[h]));  // finite: key k0 < Tk is in every tile
    float tsum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      tsum += exp_fast(s[j][2 * h] - mnew) + exp_fast(s[j][2 * h + 1] - mnew);
    rw.l[h] = rw.l[h] * exp_fast(rw.m[h] - mnew) + quad_sum(tsum);  // first tile: exp(-inf) = 0
    rw.m[h] = mnew;
  }
}

// pass 2 on one tile: the normalised probabilities, rounded to bf16 in the A
// fragments of p.v, times the tile's V rows, added to o (16 x 64 fp32);
// rw.l holds 1 / l. `s` holds the tile's raw scores, or with kScaled the
// scores fold_stats left (the same bits `scaled` gives the raw ones).
template <bool kTail, bool kScaled = false>
__device__ __forceinline__ void add_pv(float (&o)[8][4], const Rows& rw, float (&s)[8][4], int k0,
                                       int lane, int Tq, int Tk, const float* bias, float scale,
                                       const __nv_bfloat16* Vs) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + j * 8 + (lane & 3) * 2 + (e & 1), h = e >> 1;
      s[j][e] = !kTail || col < Tk
                    ? prob(kScaled ? s[j][e] : scaled(s[j][e], scale, bias, rw.i[h], col, Tq, Tk),
                           rw.m[h], rw.l[h])
                    : 0.f;
    }
  pv_product(o, s, Vs, lane);
}

}  // namespace attn
