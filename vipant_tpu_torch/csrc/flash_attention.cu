// flash_attention_{fwd,bwd,dbias}: softmax(q.k^T * scale + bias) . v per head
// with its logsumexp, and the gradient with respect to q, k, v and the bias,
// for queries and keys of different lengths (cross-attention) and for any
// layout of q, k and v that a [B, T, H, 64] view with explicit element
// strides describes: contiguous tensors, the q|k|v sections of a packed
// [B, T, 3C] projection, transposed [B, H, T, 64] views.
//
// Replaces: the Pallas kernels
//   vipant_tpu/ops/attention.py::_fwd_kernel  (line 47; launcher _fwd_call 128)
//   vipant_tpu/ops/attention.py::_bwd_kernel  (line 66; launcher _bwd_call 148)
//   vipant_tpu/ops/attention.py::_fwd_kernel4 (line 180), ::_bwd_kernel4 (200):
//     the same two on [B, T, H, D] blocks, which the strides here cover.
// On the TPU one grid step held several heads' [T, T] scores in VMEM, took
// q, k, v as [B*H, T, D] after a relayout copy (or transposed in VMEM), and
// needed Tq = Tk for its blocks. A Hopper block owns 64 query rows (or 64
// keys) of one head and streams the other side through shared memory in
// tiles of 64 (attention.cuh); no [T, T] array exists anywhere, no copy is
// made of q, k or v, and the two lengths are separate.
//
// Rounding order, as in the Pallas kernels. Forward: fp32 scores of the bf16
// q and k, times `scale`, plus the fp32 bias (each one fp32 rounding); exact
// softmax over all keys first (pass 1: row max m and row sum l; pass 2:
// p = exp(s - m) / l rounded to bf16 before p.v; an online softmax would
// rescale after p.v and round p differently); p.v accumulates in fp32 and is
// rounded to bf16 once; lse = m + log l. Backward: p = exp(s - lse) from the
// saved logsumexp (not bitwise the forward's p); delta = rowsum(do * o) from
// the rounded o; ds_raw = p * (dp - delta); dq and dk take (ds_raw * scale)
// rounded to bf16, dv takes p rounded to bf16; dbias sums the unscaled fp32
// ds_raw over all items and heads.
//
// The backward is deterministic, with no atomics:
//   flash_bwd_dq     one block per (query tile, head, item): delta (written
//                    out), then over the key tiles dq = ds . k;
//   flash_bwd_dkv    one block per (key tile, head, item), after it: over
//                    the query tiles dv = pb^T . do and dk = ds^T . q;
//   flash_dbias      one block per (query tile, key tile, chunk of items x
//                    heads): walks its chunk in order and writes one partial
//                    [Tq, Tk] sum; flash_dbias_reduce adds the chunks in
//                    order. On the TPU the grid ran in sequence and summed
//                    in place.
//
// Bound: at Tq = 77, Tk = 61 (the captioning decoder's cross-attention) a
// head is two tiles' worth of work: the kernels are bound by launch latency
// and shared-memory traffic, not by the tensor cores or the memory rate.
//
// Masking: keys past Tk get p = 0 against zero-filled rows; query rows past
// Tq are computed on zero-filled rows and never stored. A bias of -1e30
// gives p = 0; a row masked everywhere gives the uniform row (m = -1e30).

#include "attention.cuh"

namespace {

using namespace attn;

// a [B, T, H, 64] view: element strides of item, token and head (the last
// dim is contiguous)
struct View {
  const __nv_bfloat16* p;
  long long sb, st, sh;
  __device__ __forceinline__ const __nv_bfloat16* head(int b, int h) const {
    return p + b * sb + h * sh;
  }
};

struct FwdArgs {
  View q, k, v;
  const float* bias;    // [Tq, Tk] or null
  __nv_bfloat16* out;   // [B, Tq, H, 64]
  float* lse;           // [B, H, Tq]
  int Tq, Tk, H;
  float scale;
};

struct BwdArgs {
  View q, k, v, o, dout;
  const float* bias;
  const float* lse;     // [B, H, Tq]
  float* delta;         // [B, H, Tq]: written by dq, read by dkv and dbias
  __nv_bfloat16 *dq, *dk, *dv;  // [B, Tq | Tk, H, 64]
  int Tq, Tk, H;
  float scale;
};

struct DbiasArgs {
  View q, k, v, dout;
  const float* bias;
  const float* lse;
  const float* delta;
  float* partial;       // [chunks, Tq, Tk]
  int Tq, Tk, H, BH, per_chunk;
  float scale;
};

constexpr int kFwdSmem = 4 * kTileBytes + kScoreBytes;
constexpr int kDqSmem = 5 * kTileBytes + 2 * kScoreBytes;
constexpr int kDkvSmem = 6 * kTileBytes + 2 * kScoreBytes + 2 * BQ * 4;
constexpr int kDbiasSmem = 4 * kTileBytes + 2 * kScoreBytes;

// 16 x 64 fp32 fragments (this warp's rows of a tile) -> rows r0 + warp*16 +
// rr of head h of dst [B, T, H, 64], rounded once to bf16; rows past T skipped
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, FragC (&f)[D / 16], float* Ss,
                                           int warp, int lane, int b, int h, int r0, int T, int H) {
#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj)
    wmma::store_matrix_sync(Ss + warp * 16 * LDS + dj * 16, f[dj], LDS, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * D; e += 32) {
    const int rr = e / D, d = e % D;
    const int row = r0 + warp * 16 + rr;
    if (row < T)
      dst[((static_cast<size_t>(b) * T + row) * H + h) * D + d] =
          __float2bfloat16(Ss[(warp * 16 + rr) * LDS + d]);
  }
}

__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * LDH;
  __nv_bfloat16* Vs = Ks + BKV * LDH;
  __nv_bfloat16* Ps = Vs + BKV * LDH;
  float* Ss = reinterpret_cast<float*>(Ps + BQ * LDH);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int Tq = a.Tq, Tk = a.Tk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16* kbase = a.k.head(b, h);
  const __nv_bfloat16* vbase = a.v.head(b, h);
  const int kst = static_cast<int>(a.k.st), vst = static_cast<int>(a.v.st);

  // each lane owns half of one of the warp's 16 rows
  const int r = lane >> 1, half = lane & 1;
  const int i = q0 + warp * 16 + r;  // global query index
  float* srow = Ss + (warp * 16 + r) * LDS + half * 32;
  __nv_bfloat16* prow = Ps + (warp * 16 + r) * LDH + half * 32;

  load_rows(Qs, a.q.head(b, h), q0, Tq, static_cast<int>(a.q.st));
  const int nkt = (Tk + BKV - 1) / BKV;

  // pass 1: row max and row sum over all keys
  float m = -INFINITY, l = 0.f;
  for (int t = 0; t < nkt; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // previous tile's readers are done with Ks
    load_rows(Ks, kbase, k0, Tk, kst);
    __syncthreads();
    score_tile(Qs, Ks, Ss, warp);
    float tmax = -INFINITY;
    for (int c = 0; c < 32; ++c) {
      const int j = k0 + half * 32 + c;
      if (j < Tk) {
        const float s = scaled(srow[c], a.scale, a.bias, i, j, Tq, Tk);
        srow[c] = s;
        tmax = fmaxf(tmax, s);
      }
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float mnew = fmaxf(m, tmax);
    float tsum = 0.f;
    for (int c = 0; c < 32; ++c) {
      const int j = k0 + half * 32 + c;
      if (j < Tk) tsum += expf(srow[c] - mnew);
    }
    tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
    l = l * expf(m - mnew) + tsum;  // m = -inf on the first tile: exp(-inf) = 0
    m = mnew;
    __syncwarp();
  }
  if (i < Tq && half == 0) a.lse[(static_cast<size_t>(b) * a.H + h) * Tq + i] = m + logf(l);

  // pass 2: normalised bf16 p, then p.v accumulated in fp32
  const float inv_l = 1.f / l;
  FragC o[D / 16];
#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj) wmma::fill_fragment(o[dj], 0.f);
  for (int t = 0; t < nkt; ++t) {
    const int k0 = t * BKV;
    __syncthreads();
    load_rows(Ks, kbase, k0, Tk, kst);
    load_rows(Vs, vbase, k0, Tk, vst);
    __syncthreads();
    score_tile(Qs, Ks, Ss, warp);
    for (int c = 0; c < 32; ++c) {
      const int j = k0 + half * 32 + c;
      float p = 0.f;
      if (j < Tk) p = prob(scaled(srow[c], a.scale, a.bias, i, j, Tq, Tk), m, inv_l);
      prow[c] = __float2bfloat16(p);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BKV; kk += 16) {
      FragA pa;
      wmma::load_matrix_sync(pa, Ps + warp * 16 * LDH + kk, LDH);
#pragma unroll
      for (int dj = 0; dj < D / 16; ++dj) {
        FragBr vb;
        wmma::load_matrix_sync(vb, Vs + kk * LDH + dj * 16, LDH);
        wmma::mma_sync(o[dj], pa, vb, o[dj]);
      }
    }
  }
  store_rows(a.out, o, Ss, warp, lane, b, h, q0, Tq, a.H);
}

// p = exp(s - lse) and ds_raw = p * (dp - delta) for one score
__device__ __forceinline__ float prob_lse(float s, float lse) { return expf(s - lse); }
__device__ __forceinline__ float ds_raw(float p, float dp, float delta) {
  return __fmul_rn(p, __fsub_rn(dp, delta));
}

__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + BQ * LDH;
  __nv_bfloat16* Ks = dOs + BQ * LDH;  // holds the o tile first, for delta
  __nv_bfloat16* Vs = Ks + BKV * LDH;
  __nv_bfloat16* dSs = Vs + BKV * LDH;
  float* Ss = reinterpret_cast<float*>(dSs + BQ * LDH);
  float* dPs = Ss + BQ * LDS;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int Tq = a.Tq, Tk = a.Tk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16* kbase = a.k.head(b, h);
  const __nv_bfloat16* vbase = a.v.head(b, h);
  const int kst = static_cast<int>(a.k.st), vst = static_cast<int>(a.v.st);

  const int r = lane >> 1, half = lane & 1;
  const int ri = warp * 16 + r, i = q0 + ri;
  const size_t stat_i = (static_cast<size_t>(b) * a.H + h) * Tq + i;
  const float lse = i < Tq ? a.lse[stat_i] : 0.f;
  const float* srow = Ss + ri * LDS + half * 32;
  const float* dprow = dPs + ri * LDS + half * 32;
  __nv_bfloat16* dsrow = dSs + ri * LDH + half * 32;

  load_rows(Qs, a.q.head(b, h), q0, Tq, static_cast<int>(a.q.st));
  load_rows(dOs, a.dout.head(b, h), q0, Tq, static_cast<int>(a.dout.st));
  load_rows(Ks, a.o.head(b, h), q0, Tq, static_cast<int>(a.o.st));
  __syncthreads();

  // delta = rowsum(do * o), from the rounded o
  float delta = 0.f;
  for (int c = 0; c < 32; ++c) {
    const int d = half * 32 + c;
    delta += __bfloat162float(dOs[ri * LDH + d]) * __bfloat162float(Ks[ri * LDH + d]);
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);
  if (i < Tq && half == 0) a.delta[stat_i] = delta;

  FragC dq[D / 16];
#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj) wmma::fill_fragment(dq[dj], 0.f);
  const int nkt = (Tk + BKV - 1) / BKV;
  for (int t = 0; t < nkt; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // the o tile, or the previous key tile, has been read
    load_rows(Ks, kbase, k0, Tk, kst);
    load_rows(Vs, vbase, k0, Tk, vst);
    __syncthreads();
    score_tile(Qs, Ks, Ss, warp);
    score_tile(dOs, Vs, dPs, warp);
    for (int c = 0; c < 32; ++c) {
      const int j = k0 + half * 32 + c;
      float ds = 0.f;
      if (i < Tq && j < Tk) {
        const float p = prob_lse(scaled(srow[c], a.scale, a.bias, i, j, Tq, Tk), lse);
        ds = __fmul_rn(ds_raw(p, dprow[c], delta), a.scale);
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
  store_rows(a.dq, dq, Ss, warp, lane, b, h, q0, Tq, a.H);
}

__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BKV * LDH;
  __nv_bfloat16* Qs = Vs + BKV * LDH;
  __nv_bfloat16* dOs = Qs + BQ * LDH;
  __nv_bfloat16* Ps = dOs + BQ * LDH;
  __nv_bfloat16* dSs = Ps + BQ * LDH;
  float* Ss = reinterpret_cast<float*>(dSs + BQ * LDH);
  float* dPs = Ss + BQ * LDS;
  float* lses = dPs + BQ * LDS;  // the query tile's lse and delta
  float* dls = lses + BQ;

  const int k0 = blockIdx.x * BKV, h = blockIdx.y, b = blockIdx.z;
  const int Tq = a.Tq, Tk = a.Tk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16* qbase = a.q.head(b, h);
  const __nv_bfloat16* dobase = a.dout.head(b, h);
  const int qst = static_cast<int>(a.q.st), dost = static_cast<int>(a.dout.st);
  const size_t stat0 = (static_cast<size_t>(b) * a.H + h) * Tq;

  // each lane owns half of one of the warp's 16 query rows of the tile
  const int r = lane >> 1, half = lane & 1;
  const int ri = warp * 16 + r;
  const float* srow = Ss + ri * LDS + half * 32;
  const float* dprow = dPs + ri * LDS + half * 32;
  __nv_bfloat16* prow = Ps + ri * LDH + half * 32;
  __nv_bfloat16* dsrow = dSs + ri * LDH + half * 32;

  load_rows(Ks, a.k.head(b, h), k0, Tk, static_cast<int>(a.k.st));
  load_rows(Vs, a.v.head(b, h), k0, Tk, static_cast<int>(a.v.st));

  FragC dk[D / 16], dv[D / 16];  // this warp's 16 keys x 64
#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj) {
    wmma::fill_fragment(dk[dj], 0.f);
    wmma::fill_fragment(dv[dj], 0.f);
  }
  const int nqt = (Tq + BQ - 1) / BQ;
  for (int t = 0; t < nqt; ++t) {
    const int q0 = t * BQ;
    __syncthreads();  // the previous tile's readers are done
    load_rows(Qs, qbase, q0, Tq, qst);
    load_rows(dOs, dobase, q0, Tq, dost);
    for (int e = threadIdx.x; e < BQ; e += kThreads) {
      const bool in = q0 + e < Tq;
      lses[e] = in ? a.lse[stat0 + q0 + e] : 0.f;
      dls[e] = in ? a.delta[stat0 + q0 + e] : 0.f;
    }
    __syncthreads();
    score_tile(Qs, Ks, Ss, warp);
    score_tile(dOs, Vs, dPs, warp);
    const int i = q0 + ri;
    for (int c = 0; c < 32; ++c) {
      const int j = k0 + half * 32 + c;
      float p = 0.f, ds = 0.f;
      if (i < Tq && j < Tk) {
        p = prob_lse(scaled(srow[c], a.scale, a.bias, i, j, Tq, Tk), lses[ri]);
        ds = __fmul_rn(ds_raw(p, dprow[c], dls[ri]), a.scale);
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
  store_rows(a.dk, dk, Ss, warp, lane, b, h, k0, Tk, a.H);
  __syncwarp();
  store_rows(a.dv, dv, Ss, warp, lane, b, h, k0, Tk, a.H);
}

__global__ void __launch_bounds__(kThreads) flash_dbias_kernel(DbiasArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + BQ * LDH;
  __nv_bfloat16* Ks = dOs + BQ * LDH;
  __nv_bfloat16* Vs = Ks + BKV * LDH;
  float* Ss = reinterpret_cast<float*>(Vs + BKV * LDH);
  float* dPs = Ss + BQ * LDS;

  const int q0 = blockIdx.x * BQ, k0 = blockIdx.y * BKV, chunk = blockIdx.z;
  const int Tq = a.Tq, Tk = a.Tk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int ri = warp * 16 + r, i = q0 + ri;
  const float* srow = Ss + ri * LDS + half * 32;
  const float* dprow = dPs + ri * LDS + half * 32;

  float sum[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) sum[c] = 0.f;
  const int bh0 = chunk * a.per_chunk;
  const int bh1 = min(bh0 + a.per_chunk, a.BH);
  for (int bh = bh0; bh < bh1; ++bh) {  // in order: the sum is the same in every run
    const int b = bh / a.H, h = bh % a.H;
    __syncthreads();  // the previous head's readers are done
    load_rows(Qs, a.q.head(b, h), q0, Tq, static_cast<int>(a.q.st));
    load_rows(dOs, a.dout.head(b, h), q0, Tq, static_cast<int>(a.dout.st));
    load_rows(Ks, a.k.head(b, h), k0, Tk, static_cast<int>(a.k.st));
    load_rows(Vs, a.v.head(b, h), k0, Tk, static_cast<int>(a.v.st));
    __syncthreads();
    score_tile(Qs, Ks, Ss, warp);
    score_tile(dOs, Vs, dPs, warp);
    if (i < Tq) {
      const size_t stat_i = static_cast<size_t>(bh) * Tq + i;
      const float lse = a.lse[stat_i], delta = a.delta[stat_i];
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int j = k0 + half * 32 + c;
        if (j < Tk) {
          const float p = prob_lse(scaled(srow[c], a.scale, a.bias, i, j, Tq, Tk), lse);
          sum[c] = __fadd_rn(sum[c], ds_raw(p, dprow[c], delta));
        }
      }
    }
  }
  if (i < Tq) {
    float* dst = a.partial + (static_cast<size_t>(chunk) * Tq + i) * Tk;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int j = k0 + half * 32 + c;
      if (j < Tk) dst[j] = sum[c];
    }
  }
}

__global__ void flash_dbias_reduce_kernel(const float* __restrict__ partial,
                                          float* __restrict__ dbias, int chunks, size_t n) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s = __fadd_rn(s, partial[c * n + e]);
  dbias[e] = s;
}

View view(const void* p, const long long* s) {
  return View{static_cast<const __nv_bfloat16*>(p), s[0], s[1], s[2]};
}

// the strides of a contiguous [B, T, H, 64] tensor
View dense(const void* p, int T, int H) {
  return View{static_cast<const __nv_bfloat16*>(p), static_cast<long long>(T) * H * D,
              static_cast<long long>(H) * D, D};
}

template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// q, k, v: [B, T, H, 64] views, `strides` their 9 element strides (item,
// token, head of q, then of k, then of v); out [B, Tq, H, 64] bf16 and lse
// [B, H, Tq] fp32, both contiguous
extern "C" int vt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                      const long long* strides, const void* bias, void* out,
                                      void* lse, int B, int Tq, int Tk, int H, float scale,
                                      void* stream) {
  if (B <= 0 || Tq <= 0) return 0;
  cudaError_t err = opt_in(flash_fwd_kernel, kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  FwdArgs a{view(q, strides), view(k, strides + 3), view(v, strides + 6),
            static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
            static_cast<float*>(lse), Tq, Tk, H, scale};
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, kThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// o, dout: contiguous [B, Tq, H, 64]; delta: [B, H, Tq] fp32, written here;
// dq [B, Tq, H, 64], dk and dv [B, Tk, H, 64] bf16, contiguous
extern "C" int vt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const long long* strides, const void* bias, const void* o,
                                      const void* lse, const void* dout, void* delta, void* dq,
                                      void* dk, void* dv, int B, int Tq, int Tk, int H,
                                      float scale, void* stream) {
  if (B <= 0 || Tq <= 0) return 0;
  cudaError_t err = opt_in(flash_bwd_dq_kernel, kDqSmem);
  if (err == cudaSuccess) err = opt_in(flash_bwd_dkv_kernel, kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  BwdArgs a{view(q, strides), view(k, strides + 3), view(v, strides + 6), dense(o, Tq, H),
            dense(dout, Tq, H), static_cast<const float*>(bias), static_cast<const float*>(lse),
            static_cast<float*>(delta), static_cast<__nv_bfloat16*>(dq),
            static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Tq, Tk, H, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  flash_bwd_dq_kernel<<<dim3((Tq + BQ - 1) / BQ, H, B), kThreads, kDqSmem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<<<dim3((Tk + BKV - 1) / BKV, H, B), kThreads, kDkvSmem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dbias [Tq, Tk] fp32 = sum over items and heads of ds_raw, from the lse of
// the forward and the delta of vt_flash_attention_bwd; partial: scratch
// [chunks, Tq, Tk] fp32 (a chunk past the last head writes zeros)
extern "C" int vt_flash_attention_dbias(const void* q, const void* k, const void* v,
                                        const long long* strides, const void* bias,
                                        const void* lse, const void* delta, const void* dout,
                                        void* partial, void* dbias, int B, int Tq, int Tk, int H,
                                        float scale, int chunks, void* stream) {
  if (B <= 0 || Tq <= 0) return 0;
  cudaError_t err = opt_in(flash_dbias_kernel, kDbiasSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int BH = B * H, per_chunk = (BH + chunks - 1) / chunks;
  DbiasArgs a{view(q, strides), view(k, strides + 3), view(v, strides + 6), dense(dout, Tq, H),
              static_cast<const float*>(bias), static_cast<const float*>(lse),
              static_cast<const float*>(delta), static_cast<float*>(partial), Tq, Tk, H, BH,
              per_chunk, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  flash_dbias_kernel<<<dim3((Tq + BQ - 1) / BQ, (Tk + BKV - 1) / BKV, chunks), kThreads,
                       kDbiasSmem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(Tq) * Tk;
  flash_dbias_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dbias), chunks, n);
  return static_cast<int>(cudaGetLastError());
}
