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
//   attention_bwd_dq   one block per (128 query rows, head, item), a warp per
//                      16 rows: pass 1 over the keys gives delta_i = sum_j
//                      p_ij dp_ij (written out, with 1 / l_i), pass 2 forms
//                      ds and accumulates dq = ds . k;
//   attention_bwd_dkv  one block per (64 keys, head, item), a warp per 16
//                      keys, after it: over the query tiles it accumulates
//                      dv = pb^T . do and dk = ds^T . q. Two blocks share
//                      an SM (232 registers a thread), and 64 keys waste
//                      less of the last block than 128 (T = 306: 320 rows
//                      launched, not 384).
//
// Rounding order, as in the Pallas kernel: p is recomputed in fp32 from the
// forward's m and l exactly as the forward computed it (attention.cuh:
// bitwise the forward's p, held by the tests); dp = do . v^T in fp32; delta
// sums the fp32 p times dp (not FA2's rowsum(do * o), which rounds
// differently); ds = (p * (dp - delta) * scale) rounded to bf16 before dq
// and dk; dv uses the bf16-rounded p, as p . v did in the forward.
//
// Bound: at B64 T306 H12, the bytes (qkv and do in, dqkv out in fp32 and
// bf16: 0.1173 ms); the five T x T x 64 products per head take 0.072 ms at
// the bf16 peak, and every score costs an exponential (two in dq) and a
// dozen fp32 instructions, so the kernels are bound by fp32 and
// special-function instructions and by latency more than by either. What the
// design does about it, as attention_fwd does:
//   - scores, dp, p and ds never leave registers: the warps issue
//     `mma.sync.m16n8k16` themselves (attention.cuh: `scores`), take the
//     softmax backward on the accumulators (row sums by quad shuffles) and
//     pack the bf16 ds and p straight into the A fragments of the next
//     product (`pv_product`). No fp32 score or dp tile in shared memory;
//   - the warps' own rows (q and do in dq, k and v in dkv) are A fragments
//     read once from device memory into registers;
//   - dq: K and V of the head stay in shared memory where they fit (up to
//     kDqResidentTiles * 64 = 768 keys; 92 KB at T = 306, two blocks per SM),
//     fetched once with cp.async, so pass 2 reads nothing from device memory.
//     Longer T streams tiles of 64 keys through two slots, the next in flight
//     during the math. Scores are taken 32 keys at a time to keep two blocks
//     on an SM;
//   - dkv: the query tiles (q, do and their m, 1 / l, delta) are double
//     buffered with cp.async, the next tile in flight during the math;
//     keys are the rows of its scores (k . q^T), so p^T and ds^T are A
//     fragments of dv and dk without a transpose.
//
// Masking: keys and query rows past T get p = 0 (so ds = 0) against
// zero-filled rows; rows past T are not stored. A -1e30 bias gives p = 0.

#include "attention.cuh"

namespace {

using namespace attn;
using namespace async_copy;

constexpr int kDqRows = 128;                    // query rows per dq block, a warp per 16
constexpr int kDqThreads = kDqRows / 16 * 32;
constexpr int kDkvRows = 64;                    // keys per dkv block: two blocks of 4 warps an SM
constexpr int kDkvThreads = kDkvRows / 16 * 32;
constexpr int kMaxSmem = 232448;            // what a block can be given on this card
constexpr int kDqResidentTiles = kMaxSmem / (2 * kTileBytes);  // 12 tiles of 64 keys
constexpr int kChunk = 4;                   // dq takes its scores 4 x 8 = 32 keys at a time
constexpr int kStatBytes = 3 * BQ * 4;      // a query tile's m, 1 / l and delta
constexpr int kDkvSmem = 2 * (2 * kTileBytes + kStatBytes);  // two slots of q, do and stats

struct Args {
  const __nv_bfloat16* qkv;
  const __nv_bfloat16* dout;  // [B, T, C]
  const float* bias;          // [T, T] or null
  const float* stat_m;        // [B, H, T]
  const float* stat_l;        // [B, H, T]
  float* scratch;             // [2, B, H, T]: delta, then 1 / l; written by dq, read by dkv
  float* dqkv;                // [B, T, 3C] fp32
  __nv_bfloat16* dqkv_b;      // [B, T, 3C] bf16
  int B, T, H;
  float scale;
};

// a warp's 16 x 64 fp32 result (rows i[0], i[1] of the lane) -> columns
// [col, col + 64) of dqkv and dqkv_b, rows past T skipped
__device__ __forceinline__ void store_rows(const Args& a, const float (&f)[8][4], const int (&i)[2],
                                           int b, int col, int lane) {
  const int C3 = 3 * a.H * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    if (i[hh] < a.T) {
      const size_t o = (static_cast<size_t>(b) * a.T + i[hh]) * C3 + col + (lane & 3) * 2;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        *reinterpret_cast<float2*>(a.dqkv + o + n * 8) = make_float2(f[n][2 * hh], f[n][2 * hh + 1]);
        *reinterpret_cast<__nv_bfloat162*>(a.dqkv_b + o + n * 8) =
            __floats2bfloat162_rn(f[n][2 * hh], f[n][2 * hh + 1]);
      }
    }
}

// kResident: K and V of the whole head are in shared memory, tile t in slot
// t. Otherwise two slots: tile t sits in slot t & 1 while tile t + 1 loads.
template <bool kResident>
__global__ void __launch_bounds__(kDqThreads, 2) attention_bwd_dq_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int T = a.T, nkt = (T + BKV - 1) / BKV;
  const int slots = kResident ? nkt : 2;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + slots * BKV * LDH;

  const int q0 = blockIdx.x * kDqRows, h = blockIdx.y, b = blockIdx.z;
  const int C = a.H * D, C3 = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16* item = a.qkv + static_cast<size_t>(b) * T * C3;
  const __nv_bfloat16* kbase = item + C + h * D;
  const __nv_bfloat16* vbase = item + 2 * C + h * D;
  const bool active = q0 + warp * 16 < T;  // else: every row of this warp is past T

  const int kv_rows = kResident ? nkt * BKV : BKV;
  stage_rows(Ks, kbase, 0, kv_rows, T, C3, kDqThreads);
  stage_rows(Vs, vbase, 0, kv_rows, T, C3, kDqThreads);
  cp_async_commit();

  // while K and V land: this warp's q and do rows, and their statistics
  uint32_t qf[4][4], dof[4][4];
  load_a_frags(qf, item + h * D, q0 + warp * 16, T, C3, lane);
  load_a_frags(dof, a.dout + static_cast<size_t>(b) * T * C + h * D, q0 + warp * 16, T, C, lane);
  int i[2];
  float m[2], inv_l[2], delta[2];
  const size_t stat0 = (static_cast<size_t>(b) * a.H + h) * T;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    i[hh] = q0 + warp * 16 + (lane >> 2) + 8 * hh;
    m[hh] = i[hh] < T ? a.stat_m[stat0 + i[hh]] : 0.f;
    inv_l[hh] = i[hh] < T ? 1.f / a.stat_l[stat0 + i[hh]] : 1.f;
    delta[hh] = 0.f;
  }
  if constexpr (kResident) {
    cp_async_wait<0>();
    __syncthreads();
  }

  float s[kChunk][4], dp[kChunk][4];
  // pass 1: delta = sum_j p * dp over all keys
  for (int t = 0; t < nkt; ++t) {
    if constexpr (!kResident) {
      // slot (t + 1) & 1 was last read at tile t - 1, before that tile's closing barrier
      if (t + 1 < nkt) {
        stage_rows(Ks + ((t + 1) & 1) * BKV * LDH, kbase, (t + 1) * BKV, BKV, T, C3, kDqThreads);
        stage_rows(Vs + ((t + 1) & 1) * BKV * LDH, vbase, (t + 1) * BKV, BKV, T, C3, kDqThreads);
      }
      cp_async_commit();  // possibly empty: "all but the newest group" is tile t
      cp_async_wait<1>();
      __syncthreads();
    }
    if (active) {
      const int slot = kResident ? t : t & 1;
#pragma unroll
      for (int c = 0; c < BKV / (8 * kChunk); ++c) {
        const int off = (slot * BKV + c * 8 * kChunk) * LDH;
        scores(s, qf, Ks + off, lane);
        scores(dp, dof, Vs + off, lane);
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = t * BKV + (c * kChunk + j) * 8 + (lane & 3) * 2 + (e & 1), hh = e >> 1;
            if (col < T && i[hh] < T)
              delta[hh] += prob(scaled(s[j][e], a.scale, a.bias, i[hh], col, T), m[hh], inv_l[hh]) *
                           dp[j][e];
          }
      }
    }
    if constexpr (!kResident) __syncthreads();
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    delta[hh] = quad_sum(delta[hh]);
    if ((lane & 3) == 0 && i[hh] < T) {
      a.scratch[stat0 + i[hh]] = delta[hh];
      a.scratch[static_cast<size_t>(a.B) * a.H * T + stat0 + i[hh]] = inv_l[hh];
    }
  }

  // pass 2: ds, and dq = ds . k accumulated in fp32
  if constexpr (!kResident) {
    stage_rows(Ks, kbase, 0, BKV, T, C3, kDqThreads);
    stage_rows(Vs, vbase, 0, BKV, T, C3, kDqThreads);
    cp_async_commit();
  }
  float dq[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  for (int t = 0; t < nkt; ++t) {
    if constexpr (!kResident) {
      if (t + 1 < nkt) {
        stage_rows(Ks + ((t + 1) & 1) * BKV * LDH, kbase, (t + 1) * BKV, BKV, T, C3, kDqThreads);
        stage_rows(Vs + ((t + 1) & 1) * BKV * LDH, vbase, (t + 1) * BKV, BKV, T, C3, kDqThreads);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
    }
    if (active) {
      const int slot = kResident ? t : t & 1;
#pragma unroll
      for (int c = 0; c < BKV / (8 * kChunk); ++c) {
        const int off = (slot * BKV + c * 8 * kChunk) * LDH;
        scores(s, qf, Ks + off, lane);
        scores(dp, dof, Vs + off, lane);
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = t * BKV + (c * kChunk + j) * 8 + (lane & 3) * 2 + (e & 1), hh = e >> 1;
            float ds = 0.f;
            if (col < T && i[hh] < T) {
              const float p = prob(scaled(s[j][e], a.scale, a.bias, i[hh], col, T), m[hh], inv_l[hh]);
              ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[j][e], delta[hh])), a.scale);
            }
            s[j][e] = ds;
          }
        pv_product(dq, s, Ks + off, lane);  // dq += bf16(ds) . k over these 32 keys
      }
    }
    if constexpr (!kResident) __syncthreads();
  }
  store_rows(a, dq, i, b, h * D, lane);
}

// the query tile [q0, q0 + 64): q and do rows, and m, 1 / l, delta, into one slot
__device__ __forceinline__ void stage_query_tile(const Args& a, unsigned char* slot, int b, int h,
                                                 int q0) {
  const int T = a.T, C = a.H * D, C3 = 3 * C;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(slot);
  stage_rows(Qs, a.qkv + static_cast<size_t>(b) * T * C3 + h * D, q0, BQ, T, C3, kDkvThreads);
  stage_rows(Qs + BQ * LDH, a.dout + static_cast<size_t>(b) * T * C + h * D, q0, BQ, T, C, kDkvThreads);
  float* st = reinterpret_cast<float*>(slot + 2 * kTileBytes);
  const size_t stat0 = (static_cast<size_t>(b) * a.H + h) * T, bht = static_cast<size_t>(a.B) * a.H * T;
  for (int e = threadIdx.x; e < 3 * BQ; e += kDkvThreads) {
    const int which = e / BQ, r = e % BQ;
    const bool in = q0 + r < T;
    const float* src = which == 0 ? a.stat_m : a.scratch + (which == 1 ? 0 : bht);
    cp_async4(st + e, src + (in ? stat0 + q0 + r : 0), in);
  }
}

__global__ void __launch_bounds__(kDkvThreads, 2) attention_bwd_dkv_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kSlotBytes = 2 * kTileBytes + kStatBytes;
  const int T = a.T, nqt = (T + BQ - 1) / BQ;
  const int k0 = blockIdx.x * kDkvRows, h = blockIdx.y, b = blockIdx.z;
  const int C = a.H * D, C3 = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16* item = a.qkv + static_cast<size_t>(b) * T * C3;
  const bool active = k0 + warp * 16 < T;

  stage_query_tile(a, smem, b, h, 0);
  cp_async_commit();

  // while the first query tile lands: this warp's k and v rows
  uint32_t kf[4][4], vf[4][4];
  load_a_frags(kf, item + C + h * D, k0 + warp * 16, T, C3, lane);
  load_a_frags(vf, item + 2 * C + h * D, k0 + warp * 16, T, C3, lane);
  int key[2];
  key[0] = k0 + warp * 16 + (lane >> 2);
  key[1] = key[0] + 8;

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  float sT[kChunk][4], dpT[kChunk][4];  // keys are the rows: sT[j] holds queries 8 j .. 8 j + 7

  for (int t = 0; t < nqt; ++t) {
    // slot (t + 1) & 1 was last read at tile t - 1, before that tile's closing barrier
    if (t + 1 < nqt) stage_query_tile(a, smem + ((t + 1) & 1) * kSlotBytes, b, h, (t + 1) * BQ);
    cp_async_commit();  // possibly empty: "all but the newest group" is tile t
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      unsigned char* slot = smem + (t & 1) * kSlotBytes;
      const __nv_bfloat16* Qs = reinterpret_cast<const __nv_bfloat16*>(slot);
      const __nv_bfloat16* dOs = Qs + BQ * LDH;
      const float* st = reinterpret_cast<const float*>(slot + 2 * kTileBytes);  // m, delta, 1 / l
#pragma unroll
      for (int c = 0; c < BQ / (8 * kChunk); ++c) {
        scores(sT, kf, Qs + c * 8 * kChunk * LDH, lane);
        scores(dpT, vf, dOs + c * 8 * kChunk * LDH, lane);
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = (c * kChunk + j) * 8 + (lane & 3) * 2 + (e & 1), qi = t * BQ + r;
            const int kj = key[e >> 1];
            float p = 0.f, ds = 0.f;
            if (qi < T && kj < T) {
              p = prob(scaled(sT[j][e], a.scale, a.bias, qi, kj, T), st[r], st[2 * BQ + r]);
              ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dpT[j][e], st[BQ + r])), a.scale);
            }
            sT[j][e] = p;
            dpT[j][e] = ds;
          }
        pv_product(dv, sT, dOs + c * 8 * kChunk * LDH, lane);  // dv += bf16(p)^T . do
        pv_product(dk, dpT, Qs + c * 8 * kChunk * LDH, lane);  // dk += bf16(ds)^T . q
      }
    }
    __syncthreads();
  }
  store_rows(a, dk, key, b, C + h * D, lane);
  store_rows(a, dv, key, b, 2 * C + h * D, lane);
}

template <bool kResident>
cudaError_t launch_dq(const Args& a, int slots, cudaStream_t stream) {
  const int smem = 2 * slots * kTileBytes;
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel<kResident>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + kDqRows - 1) / kDqRows, a.H, a.B);
  attention_bwd_dq_kernel<kResident><<<grid, kDqThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// stats: [2, B, H, T] from vt_attention_fwd; scratch: [2, B, H, T] fp32
extern "C" int vt_attention_bwd(const void* qkv, const void* dout, const void* bias,
                                const void* stats, void* scratch, void* dqkv, void* dqkv_b, int B,
                                int T, int H, float scale, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const float* stat_m = static_cast<const float*>(stats);
  const Args a{static_cast<const __nv_bfloat16*>(qkv),
               static_cast<const __nv_bfloat16*>(dout),
               static_cast<const float*>(bias),
               stat_m,
               stat_m + static_cast<size_t>(B) * H * T,
               static_cast<float*>(scratch),
               static_cast<float*>(dqkv),
               static_cast<__nv_bfloat16*>(dqkv_b),
               B,
               T,
               H,
               scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nkt = (T + BKV - 1) / BKV;
  cudaError_t err = nkt <= kDqResidentTiles ? launch_dq<true>(a, nkt, s) : launch_dq<false>(a, 2, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kDkvRows - 1) / kDkvRows, H, B);
  attention_bwd_dkv_kernel<<<grid, kDkvThreads, kDkvSmem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
