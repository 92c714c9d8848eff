// attention_fwd: softmax(q.k^T * scale + bias) . v for every head, reading
// the packed [B, T, 3C] projection and writing [B, T, C]; for training also
// the softmax's row max and row sum, which attention_bwd reads.
//
// Replaces: the score / softmax / context steps of the Pallas kernel
//   vipant_tpu/ops/fused_attn.py::_fwd_kernel (lines 105-111).
// On the TPU one grid step held all heads' [H, T, T] scores in VMEM. A
// Hopper block has 227 KB of shared memory and many blocks must be in
// flight, so the work is cut into one block per (128 query rows, head,
// item), 8 warps of 16 rows each.
//
// Bound: at T ~ 300 and D = 64 the products are small (2*T*T*D per head
// and pass) and every score costs two exponentials: the kernel is bound by
// fp32 and special-function instructions and by latency more than by the
// tensor cores or the memory rate. What the design does about it:
//   - scores and probabilities never leave registers. The warp executes
//     `mma.sync.m16n8k16` itself, so a thread knows which (row, column) each
//     accumulator holds: scale, bias, row max and row sum are taken on the
//     accumulators (a row lives in the four lanes of a quad: two shuffles),
//     and the bf16 probabilities are packed straight into the A fragments of
//     p.v. No score tile and no probability tile in shared memory;
//   - K and V of the whole head stay in shared memory where they fit (up to
//     kResidentTiles * 64 = 704 keys; 92 KB at T = 306, two blocks per SM),
//     fetched once with cp.async: K first, V behind it while pass 1 runs, so
//     pass 2 reads nothing from device memory. Longer T streams tiles of 64
//     keys through a two-slot ring, the next tile in flight during the math;
//   - fragments come from shared memory with `ldmatrix` over a 144-byte
//     pitch (no bank conflicts), V through its transposing form.
//
// Rounding order, as in the Pallas kernel: scores are fp32 products of the
// bf16 q and k, multiplied by `scale`, then the fp32 bias is added; the
// softmax is exact (row max and sum in fp32 over all keys first, then
// p = exp(s - max) * (1 / sum)) and p is rounded to bf16 before p.v, which
// accumulates in fp32 and is rounded to bf16 once. A flash-style online
// softmax would rescale after p.v and so round p differently; hence two
// passes over the keys, the second recomputing q.k^T on tensor cores that
// are far from busy.
//
// Layout and masking: see attention.cuh. Keys past T get probability 0
// against zero-filled v rows; query rows past T are not stored, and a warp
// whose 16 rows all lie past T only helps with the loads.
//
// attention_fwd_f32 is the same kernel with the context stored in fp32,
// unrounded: the int8 sub-block (vipant_tpu/ops/fused_attn.py::
// _fwd_int8_kernel, lines 155-158) quantizes the context from fp32, with one
// scale per token over all heads, which no (query tile, head) block holds;
// quant.cu's rowquant reads it back.

#include <stdint.h>

#include "async_copy.cuh"
#include "attention.cuh"

namespace {

using namespace attn;
using namespace async_copy;

constexpr int kFwdQ = 128;                        // query rows per block
constexpr int kFwdThreads = kFwdQ / 16 * 32;      // one warp per 16 rows
constexpr int kQBytes = kFwdQ * LDH * 2;
constexpr int kMaxSmem = 232448;                  // what a block can be given on this card
constexpr int kResidentTiles = (kMaxSmem - kQBytes) / (2 * kTileBytes);  // 11 tiles of 64 keys

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

// rows [r0, r0 + nrows) of one head's 64 columns (row stride `ld`) into a
// tile of pitch LDH, asynchronously; rows past T are zero
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* base, int r0,
                                           int nrows, int T, int ld) {
  for (int c = threadIdx.x; c < nrows * (D / 8); c += kFwdThreads) {
    const int r = c >> 3, k = (c & 7) * 8;
    const bool in = r0 + r < T;
    cp_async16(dst + r * LDH + k, in ? base + static_cast<size_t>(r0 + r) * ld + k : base, in);
  }
}

// raw fp32 scores of this warp's 16 query rows (A fragments qf, one per 16
// of the 64 head dims) against the 64 keys of tile Ks: s[j] is the 16 x 8
// block of keys 8 j .. 8 j + 7. Each block sums the head dim in the same four
// steps of 16, from zero, as attn::score_tile does.
__device__ __forceinline__ void scores(float (&s)[8][4], const uint32_t (&qf)[4][4],
                                       const __nv_bfloat16* Ks, int lane) {
  const __nv_bfloat16* krow = Ks + (lane & 7) * LDH + (lane >> 3) * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    uint32_t kb[4];
    ldmatrix_x4(kb, krow + j * 8 * LDH);  // head dims 0 .. 31 of keys 8 j .. 8 j + 7
    mma_16816(s[j], qf[0], kb[0], kb[1]);
    mma_16816(s[j], qf[1], kb[2], kb[3]);
    ldmatrix_x4(kb, krow + j * 8 * LDH + 32);
    mma_16816(s[j], qf[2], kb[0], kb[1]);
    mma_16816(s[j], qf[3], kb[2], kb[3]);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The state of one warp: 16 query rows, of which a lane holds two (lane / 4
// and lane / 4 + 8) and, of every 8 keys, the two at 2 (lane % 4).
struct Rows {
  int i[2];    // global query index of the lane's two rows
  float m[2];  // running row max
  float l[2];  // running row sum of exp(s - m); its reciprocal in pass 2
};

// pass 1 on one tile of 64 keys starting at k0: fold its scores into m and l.
// kTail: the tile may hold keys past T (only the last tile does).
template <bool kTail>
__device__ __forceinline__ void fold_stats(Rows& rw, float (&s)[8][4], int k0, int lane, int T,
                                           const float* bias, float scale) {
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
      s[j][e] = !kTail || col < T ? scaled(s[j][e], scale, bias, rw.i[e >> 1], col, T) : -INFINITY;
      tmax[e >> 1] = fmaxf(tmax[e >> 1], s[j][e]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mnew = fmaxf(rw.m[h], quad_max(tmax[h]));  // finite: key k0 < T is in every tile
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
// rw.l holds 1 / l
template <bool kTail>
__device__ __forceinline__ void add_pv(float (&o)[8][4], const Rows& rw, float (&s)[8][4], int k0,
                                       int lane, int T, const float* bias, float scale,
                                       const __nv_bfloat16* Vs) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + j * 8 + (lane & 3) * 2 + (e & 1), h = e >> 1;
      s[j][e] = !kTail || col < T
                    ? prob(scaled(s[j][e], scale, bias, rw.i[h], col, T), rw.m[h], rw.l[h])
                    : 0.f;
    }
  // matrix i of a transposed load: keys + 8 (i & 1), head dims + 8 (i >> 1)
  const __nv_bfloat16* vrow = Vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDH + (lane >> 4) * 8;
#pragma unroll
  for (int u = 0; u < 4; ++u) {  // keys 16 u .. 16 u + 15
    const uint32_t pa[4] = {pack_bf16(s[2 * u][0], s[2 * u][1]), pack_bf16(s[2 * u][2], s[2 * u][3]),
                            pack_bf16(s[2 * u + 1][0], s[2 * u + 1][1]),
                            pack_bf16(s[2 * u + 1][2], s[2 * u + 1][3])};
#pragma unroll
    for (int n = 0; n < 4; ++n) {  // head dims 16 n .. 16 n + 15
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vrow + u * 16 * LDH + n * 16);
      mma_16816(o[2 * n], pa, vb[0], vb[1]);
      mma_16816(o[2 * n + 1], pa, vb[2], vb[3]);
    }
  }
}

// kResident: K and V of the whole head are in shared memory, tile t in slot
// t. Otherwise two slots: tile t sits in slot t & 1 while tile t + 1 loads.
template <typename OutT, bool kResident>
__global__ void __launch_bounds__(kFwdThreads, 2)
attention_fwd_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ bias,
                     OutT* __restrict__ out, float* __restrict__ stat_m,
                     float* __restrict__ stat_l, int T, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nkt = (T + BKV - 1) / BKV;
  const int slots = kResident ? nkt : 2;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kFwdQ * LDH;
  __nv_bfloat16* Vs = Ks + slots * BKV * LDH;

  const int q0 = blockIdx.x * kFwdQ, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D, C3 = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16* item = qkv + static_cast<size_t>(b) * T * C3;
  const __nv_bfloat16* kbase = item + C + h * D;
  const __nv_bfloat16* vbase = item + 2 * C + h * D;
  const bool active = q0 + warp * 16 < T;  // else: every row of this warp is past T

  stage_rows(Qs, item + h * D, q0, kFwdQ, T, C3);
  if constexpr (kResident) {
    stage_rows(Ks, kbase, 0, nkt * BKV, T, C3);
    cp_async_commit();
    stage_rows(Vs, vbase, 0, nkt * BKV, T, C3);
    cp_async_commit();
    cp_async_wait<1>();  // Q and K have landed; V follows during pass 1
  } else {
    stage_rows(Ks, kbase, 0, BKV, T, C3);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  uint32_t qf[4][4];
  {
    // matrix i of a load: rows + 8 (i & 1), head dims + 8 (i >> 1)
    const __nv_bfloat16* qrow = Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(qf[kk], qrow + kk * 16);
  }

  Rows rw;
  rw.i[0] = q0 + warp * 16 + (lane >> 2);
  rw.i[1] = rw.i[0] + 8;
  rw.m[0] = rw.m[1] = -INFINITY;
  rw.l[0] = rw.l[1] = 0.f;
  float s[8][4];

  // pass 1: row max and row sum over all keys
  for (int t = 0; t < nkt; ++t) {
    if constexpr (!kResident) {
      // slot (t + 1) & 1 was last read at tile t - 1, before that tile's closing barrier
      if (t + 1 < nkt) stage_rows(Ks + ((t + 1) & 1) * BKV * LDH, kbase, (t + 1) * BKV, BKV, T, C3);
      cp_async_commit();   // possibly empty: "all but the newest group" is tile t
      cp_async_wait<1>();
      __syncthreads();
    }
    if (active) {
      scores(s, qf, Ks + (kResident ? t : t & 1) * BKV * LDH, lane);
      if (t + 1 < nkt)
        fold_stats<false>(rw, s, t * BKV, lane, T, bias, scale);
      else
        fold_stats<true>(rw, s, t * BKV, lane, T, bias, scale);
    }
    if constexpr (!kResident) __syncthreads();
  }
  if (stat_m != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (rw.i[hh] < T) {
        const size_t row = (static_cast<size_t>(b) * H + h) * T + rw.i[hh];
        stat_m[row] = rw.m[hh];
        stat_l[row] = rw.l[hh];
      }
  }
  rw.l[0] = 1.f / rw.l[0];
  rw.l[1] = 1.f / rw.l[1];

  // pass 2: normalised bf16 p, then p.v accumulated in fp32
  if constexpr (kResident) {
    cp_async_wait<0>();
    __syncthreads();  // every thread's share of V has landed
  } else {
    stage_rows(Ks, kbase, 0, BKV, T, C3);
    stage_rows(Vs, vbase, 0, BKV, T, C3);
    cp_async_commit();
  }
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int t = 0; t < nkt; ++t) {
    const int slot = kResident ? t : t & 1;
    if constexpr (!kResident) {
      if (t + 1 < nkt) {
        stage_rows(Ks + ((t + 1) & 1) * BKV * LDH, kbase, (t + 1) * BKV, BKV, T, C3);
        stage_rows(Vs + ((t + 1) & 1) * BKV * LDH, vbase, (t + 1) * BKV, BKV, T, C3);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
    }
    if (active) {
      scores(s, qf, Ks + slot * BKV * LDH, lane);
      if (t + 1 < nkt)
        add_pv<false>(o, rw, s, t * BKV, lane, T, bias, scale, Vs + slot * BKV * LDH);
      else
        add_pv<true>(o, rw, s, t * BKV, lane, T, bias, scale, Vs + slot * BKV * LDH);
    }
    if constexpr (!kResident) __syncthreads();
  }

  // one bf16 rounding of the context, or fp32 as it is
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    if (rw.i[hh] < T) {
      OutT* orow = out + (static_cast<size_t>(b) * T + rw.i[hh]) * C + h * D + (lane & 3) * 2;
#pragma unroll
      for (int n = 0; n < 8; ++n) store_pair(orow + n * 8, o[n][2 * hh], o[n][2 * hh + 1]);
    }
}

template <typename OutT, bool kResident>
cudaError_t launch_mode(const void* qkv, const void* bias, void* out, float* stat_m, float* stat_l,
                        int B, int T, int H, float scale, int slots, cudaStream_t stream) {
  const int smem = kQBytes + 2 * slots * kTileBytes;
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<OutT, kResident>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kFwdQ - 1) / kFwdQ, H, B);
  attention_fwd_kernel<OutT, kResident><<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(bias),
      static_cast<OutT*>(out), stat_m, stat_l, T, H, scale);
  return cudaGetLastError();
}

template <typename OutT>
int launch(const void* qkv, const void* bias, void* out, void* stats, int B, int T, int H,
           float scale, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  float* stat_m = static_cast<float*>(stats);
  float* stat_l = stat_m == nullptr ? nullptr : stat_m + static_cast<size_t>(B) * H * T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nkt = (T + BKV - 1) / BKV;
  return static_cast<int>(
      nkt <= kResidentTiles
          ? launch_mode<OutT, true>(qkv, bias, out, stat_m, stat_l, B, T, H, scale, nkt, s)
          : launch_mode<OutT, false>(qkv, bias, out, stat_m, stat_l, B, T, H, scale, 2, s));
}

}  // namespace

// out [B, T, C] bf16; stats: null, or [2, B, H, T] fp32 receiving the row
// max and the row sum
extern "C" int vt_attention_fwd(const void* qkv, const void* bias, void* out, void* stats, int B,
                                int T, int H, float scale, void* stream) {
  return launch<__nv_bfloat16>(qkv, bias, out, stats, B, T, H, scale, stream);
}

// out [B, T, C] fp32, the unrounded context
extern "C" int vt_attention_fwd_f32(const void* qkv, const void* bias, void* out, int B, int T,
                                    int H, float scale, void* stream) {
  return launch<float>(qkv, bias, out, nullptr, B, T, H, scale, stream);
}
