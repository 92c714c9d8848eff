// attention_bwd: the gradient of attention_fwd with respect to the packed
// [B, T, 3C] projection, given the output grad do [B, T, C] and the
// forward's row statistics (max m, sum l). Writes dqkv twice: in fp32 (the
// qkv bias grad sums it before any rounding) and rounded once to bf16 (the
// operand of the two products that follow).
//
// Replaces: the softmax-backward steps of the Pallas kernel
//   vipant_tpu/ops/fused_attn.py::_bwd_kernel (lines 211-230).
// On the TPU one grid step held an item's [H, T, T] p, dp and ds in VMEM and
// reduced over both axes there. On Hopper the reductions run in two
// directions: dq sums over keys, dk and dv over queries. Two kernels split
// them deterministically, with no atomics:
//
//   attention_bwd_dq   one block per (query tile, head, item): pass 1 over
//                      the keys gives delta_i = sum_j p_ij dp_ij (written
//                      out), pass 2 forms ds and accumulates dq = ds . k;
//   attention_bwd_dkv  one block per (key tile, head, item), after it: over
//                      the query tiles it accumulates dv = pb^T . do and
//                      dk = ds^T . q.
//
// Rounding order, as in the Pallas kernel: p is recomputed in fp32 from the
// forward's m and l exactly as the forward computed it (same tiles, same
// instructions: bitwise the forward's p); dp = do . v^T in fp32; delta sums
// the fp32 p times dp (not FA2's rowsum(do * o), which rounds differently);
// ds = (p * (dp - delta) * scale) rounded to bf16 before dq and dk; dv uses
// the bf16-rounded p, as p . v did in the forward.
//
// Bound: like the forward, latency and shared-memory traffic at T ~ 300,
// D = 64. Each block recomputes its score and dp tiles (dq: twice, dkv:
// once) rather than keep any [T, T] array.
//
// Masking: keys and query rows past T get p = 0 (so ds = 0) against
// zero-filled rows; rows past T are not stored. A -1e30 bias gives p = 0.

#include "attention.cuh"

namespace {

using namespace attn;

constexpr int kDqSmem = 5 * kTileBytes + 2 * kScoreBytes;
constexpr int kDkvSmem = 6 * kTileBytes + 2 * kScoreBytes + 3 * BQ * 4;

struct Args {
  const __nv_bfloat16* qkv;
  const __nv_bfloat16* dout;  // [B, T, C]
  const float* bias;          // [T, T] or null
  const float* stat_m;        // [B, H, T]
  const float* stat_l;        // [B, H, T]
  float* delta;               // [B, H, T]: written by dq, read by dkv
  float* dqkv;                // [B, T, 3C] fp32
  __nv_bfloat16* dqkv_b;      // [B, T, 3C] bf16
  int T, H;
  float scale;
};

// 16 x 64 fp32 fragments (this warp's rows of a tile) -> columns [col, col +
// 64) of rows r0 + warp*16 + rr of dqkv and dqkv_b, rows past T skipped
__device__ __forceinline__ void store_rows(const Args& a, FragC (&f)[D / 16], float* Ss, int warp,
                                           int lane, int b, int r0, int col) {
  const int C3 = 3 * a.H * D;
#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj)
    wmma::store_matrix_sync(Ss + warp * 16 * LDS + dj * 16, f[dj], LDS, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * D; e += 32) {
    const int rr = e / D, d = e % D;
    const int row = r0 + warp * 16 + rr;
    if (row < a.T) {
      const float v = Ss[(warp * 16 + rr) * LDS + d];
      const size_t o = (static_cast<size_t>(b) * a.T + row) * C3 + col + d;
      a.dqkv[o] = v;
      a.dqkv_b[o] = __float2bfloat16(v);
    }
  }
}

__global__ void __launch_bounds__(kThreads) attention_bwd_dq_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + BQ * LDH;
  __nv_bfloat16* Ks = dOs + BQ * LDH;
  __nv_bfloat16* Vs = Ks + BKV * LDH;
  __nv_bfloat16* dSs = Vs + BKV * LDH;
  float* Ss = reinterpret_cast<float*>(dSs + BQ * LDH);
  float* dPs = Ss + BQ * LDS;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int T = a.T, C = a.H * D, C3 = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16* item = a.qkv + static_cast<size_t>(b) * T * C3;
  const __nv_bfloat16* kbase = item + C + h * D;
  const __nv_bfloat16* vbase = item + 2 * C + h * D;

  const int r = lane >> 1, half = lane & 1;
  const int i = q0 + warp * 16 + r;
  const size_t srow_i = (static_cast<size_t>(b) * a.H + h) * T + i;
  const float m = i < T ? a.stat_m[srow_i] : 0.f;
  const float inv_l = i < T ? 1.f / a.stat_l[srow_i] : 1.f;
  const float* srow = Ss + (warp * 16 + r) * LDS + half * 32;
  const float* dprow = dPs + (warp * 16 + r) * LDS + half * 32;
  __nv_bfloat16* dsrow = dSs + (warp * 16 + r) * LDH + half * 32;

  load_rows(Qs, item + h * D, q0, T, C3);
  load_rows(dOs, a.dout + static_cast<size_t>(b) * T * C + h * D, q0, T, C);
  const int nkt = (T + BKV - 1) / BKV;

  // pass 1: delta = sum_j p * dp over all keys
  float delta = 0.f;
  for (int t = 0; t < nkt; ++t) {
    const int k0 = t * BKV;
    __syncthreads();
    load_rows(Ks, kbase, k0, T, C3);
    load_rows(Vs, vbase, k0, T, C3);
    __syncthreads();
    score_tile(Qs, Ks, Ss, warp);
    score_tile(dOs, Vs, dPs, warp);
    for (int c = 0; c < 32; ++c) {
      const int j = k0 + half * 32 + c;
      if (i < T && j < T) delta += prob(scaled(srow[c], a.scale, a.bias, i, j, T), m, inv_l) * dprow[c];
    }
    __syncwarp();
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);
  if (i < T && half == 0) a.delta[srow_i] = delta;

  // pass 2: ds, and dq = ds . k accumulated in fp32
  FragC dq[D / 16];
#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj) wmma::fill_fragment(dq[dj], 0.f);
  for (int t = 0; t < nkt; ++t) {
    const int k0 = t * BKV;
    __syncthreads();
    load_rows(Ks, kbase, k0, T, C3);
    load_rows(Vs, vbase, k0, T, C3);
    __syncthreads();
    score_tile(Qs, Ks, Ss, warp);
    score_tile(dOs, Vs, dPs, warp);
    for (int c = 0; c < 32; ++c) {
      const int j = k0 + half * 32 + c;
      float ds = 0.f;
      if (i < T && j < T) {
        const float p = prob(scaled(srow[c], a.scale, a.bias, i, j, T), m, inv_l);
        ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dprow[c], delta)), a.scale);
      }
      dsrow[c] = __float2bfloat16(ds);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BKV; kk += 16) {
      FragA f;
      wmma::load_matrix_sync(f, dSs + warp * 16 * LDH + kk, LDH);
#pragma unroll
      for (int dj = 0; dj < D / 16; ++dj) {
        FragBr kb;
        wmma::load_matrix_sync(kb, Ks + kk * LDH + dj * 16, LDH);
        wmma::mma_sync(dq[dj], f, kb, dq[dj]);
      }
    }
  }
  store_rows(a, dq, Ss, warp, lane, b, q0, h * D);
}

__global__ void __launch_bounds__(kThreads) attention_bwd_dkv_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BKV * LDH;
  __nv_bfloat16* Qs = Vs + BKV * LDH;
  __nv_bfloat16* dOs = Qs + BQ * LDH;
  __nv_bfloat16* Ps = dOs + BQ * LDH;
  __nv_bfloat16* dSs = Ps + BQ * LDH;
  float* Ss = reinterpret_cast<float*>(dSs + BQ * LDH);
  float* dPs = Ss + BQ * LDS;
  float* ms = dPs + BQ * LDS;  // the query tile's m, 1 / l and delta
  float* ls = ms + BQ;
  float* dls = ls + BQ;

  const int k0 = blockIdx.x * BKV, h = blockIdx.y, b = blockIdx.z;
  const int T = a.T, C = a.H * D, C3 = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16* item = a.qkv + static_cast<size_t>(b) * T * C3;
  const __nv_bfloat16* dobase = a.dout + static_cast<size_t>(b) * T * C + h * D;
  const size_t stat0 = (static_cast<size_t>(b) * a.H + h) * T;

  // each lane owns half of one of the warp's 16 query rows of the tile
  const int r = lane >> 1, half = lane & 1;
  const float* srow = Ss + (warp * 16 + r) * LDS + half * 32;
  const float* dprow = dPs + (warp * 16 + r) * LDS + half * 32;
  __nv_bfloat16* prow = Ps + (warp * 16 + r) * LDH + half * 32;
  __nv_bfloat16* dsrow = dSs + (warp * 16 + r) * LDH + half * 32;

  load_rows(Ks, item + C + h * D, k0, T, C3);
  load_rows(Vs, item + 2 * C + h * D, k0, T, C3);

  FragC dk[D / 16], dv[D / 16];  // this warp's 16 keys x 64
#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj) {
    wmma::fill_fragment(dk[dj], 0.f);
    wmma::fill_fragment(dv[dj], 0.f);
  }
  const int nqt = (T + BQ - 1) / BQ;
  for (int t = 0; t < nqt; ++t) {
    const int q0 = t * BQ;
    __syncthreads();  // the previous tile's readers are done
    load_rows(Qs, item + h * D, q0, T, C3);
    load_rows(dOs, dobase, q0, T, C);
    for (int e = threadIdx.x; e < BQ; e += kThreads) {
      const bool in = q0 + e < T;
      ms[e] = in ? a.stat_m[stat0 + q0 + e] : 0.f;
      ls[e] = in ? 1.f / a.stat_l[stat0 + q0 + e] : 1.f;
      dls[e] = in ? a.delta[stat0 + q0 + e] : 0.f;
    }
    __syncthreads();
    score_tile(Qs, Ks, Ss, warp);
    score_tile(dOs, Vs, dPs, warp);
    const int ri = warp * 16 + r, i = q0 + ri;
    for (int c = 0; c < 32; ++c) {
      const int j = k0 + half * 32 + c;
      float p = 0.f, ds = 0.f;
      if (i < T && j < T) {
        p = prob(scaled(srow[c], a.scale, a.bias, i, j, T), ms[ri], ls[ri]);
        ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dprow[c], dls[ri])), a.scale);
      }
      prow[c] = __float2bfloat16(p);
      dsrow[c] = __float2bfloat16(ds);
    }
    __syncthreads();  // every warp reads all 64 query rows of Ps and dSs
    // this warp's keys [warp*16, warp*16 + 16): dv += pb^T . do, dk += ds^T . q
#pragma unroll
    for (int kk = 0; kk < BQ; kk += 16) {
      FragAc pt, dst;
      wmma::load_matrix_sync(pt, Ps + kk * LDH + warp * 16, LDH);
      wmma::load_matrix_sync(dst, dSs + kk * LDH + warp * 16, LDH);
#pragma unroll
      for (int dj = 0; dj < D / 16; ++dj) {
        FragBr ob, qb;
        wmma::load_matrix_sync(ob, dOs + kk * LDH + dj * 16, LDH);
        wmma::load_matrix_sync(qb, Qs + kk * LDH + dj * 16, LDH);
        wmma::mma_sync(dv[dj], pt, ob, dv[dj]);
        wmma::mma_sync(dk[dj], dst, qb, dk[dj]);
      }
    }
  }
  __syncthreads();  // Ss is reused as the store scratch
  store_rows(a, dk, Ss, warp, lane, b, k0, C + h * D);
  __syncwarp();
  store_rows(a, dv, Ss, warp, lane, b, k0, 2 * C + h * D);
}

}  // namespace

// stats: [2, B, H, T] from vt_attention_fwd; delta: [B, H, T] scratch
extern "C" int vt_attention_bwd(const void* qkv, const void* dout, const void* bias,
                                const void* stats, void* delta, void* dqkv, void* dqkv_b, int B,
                                int T, int H, float scale, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_bwd_dkv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* stat_m = static_cast<const float*>(stats);
  Args a{static_cast<const __nv_bfloat16*>(qkv),
         static_cast<const __nv_bfloat16*>(dout),
         static_cast<const float*>(bias),
         stat_m,
         stat_m + static_cast<size_t>(B) * H * T,
         static_cast<float*>(delta),
         static_cast<float*>(dqkv),
         static_cast<__nv_bfloat16*>(dqkv_b),
         T,
         H,
         scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  attention_bwd_dq_kernel<<<grid, kThreads, kDqSmem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_kernel<<<grid, kThreads, kDkvSmem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
