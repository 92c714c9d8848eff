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
// needed Tq = Tk for its blocks. Here no [T, T] array exists anywhere, no
// copy is made of q, k or v, and the two lengths are separate.
//
// Forward: attention.cu's register design on the strided views. One block
// per (query tile, head, item), its rows sized to Tq in warps of 16
// (kernels.flash_fwd_plan: one block of 5 warps per head at the decoder's
// Tq = 77, blocks of 128 rows at T = 971). Each warp issues
// `mma.sync.m16n8k16` itself (attention.cuh's `scores`, `fold_stats`,
// `add_pv`), so scores and probabilities stay in registers; fragments come
// from shared memory through `ldmatrix` over the 144-byte pitch. K and V of
// the head stay resident in shared memory up to 704 keys, fetched once with
// cp.async from the views, V behind K while pass 1 runs; longer keys stream
// through a two-slot ring, the next tile in flight. Where every key fits in
// one tile (the decoder's Tk = 61) the scaled scores of pass 1 stay in
// registers for pass 2 and are not recomputed, and blocks of at most 5
// warps are compiled for 4 an SM, so the captioning step's 512 blocks run
// in one wave (on an H100, 14.7 us at 3 an SM against 11.0: the schedules are
// in experiments/flash_fwd_variants.py). o goes out from the accumulators
// in bf16 pairs. The backward kernels below keep their first
// design: a block owns 64 query rows (or 64 keys) and streams the other side
// through shared memory in tiles of 64, its scores passing through an fp32
// tile (attention.cuh's `score_tile`).
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
// Bound: at Tq = 77, Tk = 61, B = 64, H = 8 (the captioning decoder's
// cross-attention) the forward moves 18 MB (q, k and v read once, o and lse
// written once): 5.4 us at 3.35 TB/s, against 0.3 GFLOP of products; the
// work per head is one 64-key tile, so the forward is bound by the latency
// of its loads and by how many heads are in flight, not by the tensor cores.
// The backward's 5 products are bound the same way at that shape.
//
// Masking: keys past Tk get p = 0 against zero-filled rows; query rows past
// Tq are computed on zero-filled rows and never stored. A bias of -1e30
// gives p = 0; a row masked everywhere gives the uniform row (m = -1e30).

#include "attention.cuh"

namespace {

using namespace attn;
using namespace async_copy;

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

constexpr int kFwdMaxRows = 128;  // query rows a forward block holds at most (kernels.FLASH_MAX_Q)
// ... where every key fits one tile (kernels.FLASH_ONE_TILE_Q): 5 warps, so that 4 blocks an SM
// fit in the register file with their scores kept from pass 1 to pass 2
constexpr int kOneTileMaxRows = 80;
constexpr int kMaxSmem = 232448;                      // what a block can be given on this card
// tiles of 64 keys whose K and V stay resident beside the largest Q tile: 11, 704 keys
constexpr int kResidentTiles = (kMaxSmem - kFwdMaxRows * LDH * 2) / (2 * kTileBytes);
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

// How a forward block holds the keys and values of its head: every key in
// one 64-key tile, the scores kept in registers from pass 1 to pass 2
// (kOneTile); all tiles resident in shared memory, tile t in slot t
// (kResident); or tiles streaming through two slots, tile t in slot t & 1
// while tile t + 1 loads (kStreaming, past kResidentTiles).
enum FwdMode { kOneTile, kResident, kStreaming };

// The forward: one block of `blockDim.x / 32` warps of 16 query rows per
// (query tile of rows_per_block rows, head, item). Resident K and V are
// fetched once, V behind K, landing while pass 1 runs. The bounds: kOneTile
// blocks of at most 5 warps, 4 an SM (at most 102 registers); the others up
// to 8 warps at whatever the registers allow, so that nothing spills.
template <FwdMode kMode>
__global__ void __launch_bounds__((kMode == kOneTile ? kOneTileMaxRows : kFwdMaxRows) * 2,
                                  kMode == kOneTile ? 4 : 1)
flash_fwd_kernel(FwdArgs a) {
  constexpr bool kAll = kMode != kStreaming;  // every key tile resident
  extern __shared__ __align__(128) unsigned char smem[];
  const int threads = blockDim.x, rows = threads / 2;  // 16 query rows a warp
  const int Tq = a.Tq, Tk = a.Tk, nkt = kMode == kOneTile ? 1 : (Tk + BKV - 1) / BKV;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + rows * LDH;
  __nv_bfloat16* Vs = Ks + (kAll ? nkt : 2) * BKV * LDH;

  const int q0 = blockIdx.x * rows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16* kbase = a.k.head(b, h);
  const __nv_bfloat16* vbase = a.v.head(b, h);
  const int kst = static_cast<int>(a.k.st), vst = static_cast<int>(a.v.st);
  const bool active = q0 + warp * 16 < Tq;  // else: every row of this warp is past Tq

  stage_rows(Qs, a.q.head(b, h), q0, rows, Tq, static_cast<int>(a.q.st), threads);
  stage_rows(Ks, kbase, 0, (kAll ? nkt : 1) * BKV, Tk, kst, threads);
  cp_async_commit();
  if constexpr (kAll) {
    stage_rows(Vs, vbase, 0, nkt * BKV, Tk, vst, threads);
    cp_async_commit();
    cp_async_wait<1>();  // Q and K have landed; V follows during pass 1
  } else {
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
    if constexpr (!kAll) {
      // slot (t + 1) & 1 was last read at tile t - 1, before that tile's closing barrier
      if (t + 1 < nkt) stage_rows(Ks + ((t + 1) & 1) * BKV * LDH, kbase, (t + 1) * BKV, BKV, Tk, kst, threads);
      cp_async_commit();  // possibly empty: "all but the newest group" is tile t
      cp_async_wait<1>();
      __syncthreads();
    }
    if (active) {
      scores(s, qf, Ks + (kAll ? t : t & 1) * BKV * LDH, lane);
      if (t + 1 < nkt)
        fold_stats<false>(rw, s, t * BKV, lane, Tq, Tk, a.bias, a.scale);
      else
        fold_stats<true>(rw, s, t * BKV, lane, Tq, Tk, a.bias, a.scale);
    }
    if constexpr (!kAll) __syncthreads();
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (rw.i[hh] < Tq) a.lse[(static_cast<size_t>(b) * a.H + h) * Tq + rw.i[hh]] = rw.m[hh] + logf(rw.l[hh]);
  }
  rw.l[0] = 1.f / rw.l[0];
  rw.l[1] = 1.f / rw.l[1];

  // pass 2: normalised bf16 p, then p.v accumulated in fp32
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  if constexpr (kAll) {
    cp_async_wait<0>();
    __syncthreads();  // every thread's share of V has landed
    if constexpr (kMode == kOneTile) {
      if (active) add_pv<true, true>(o, rw, s, 0, lane, Tq, Tk, a.bias, a.scale, Vs);  // s: pass 1's
    } else {
      for (int t = 0; active && t < nkt; ++t) {
        scores(s, qf, Ks + t * BKV * LDH, lane);
        if (t + 1 < nkt)
          add_pv<false>(o, rw, s, t * BKV, lane, Tq, Tk, a.bias, a.scale, Vs + t * BKV * LDH);
        else
          add_pv<true>(o, rw, s, t * BKV, lane, Tq, Tk, a.bias, a.scale, Vs + t * BKV * LDH);
      }
    }
  } else {
    stage_rows(Ks, kbase, 0, BKV, Tk, kst, threads);
    stage_rows(Vs, vbase, 0, BKV, Tk, vst, threads);
    cp_async_commit();
    for (int t = 0; t < nkt; ++t) {
      const int slot = t & 1;
      if (t + 1 < nkt) {
        stage_rows(Ks + (slot ^ 1) * BKV * LDH, kbase, (t + 1) * BKV, BKV, Tk, kst, threads);
        stage_rows(Vs + (slot ^ 1) * BKV * LDH, vbase, (t + 1) * BKV, BKV, Tk, vst, threads);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      if (active) {
        scores(s, qf, Ks + slot * BKV * LDH, lane);
        if (t + 1 < nkt)
          add_pv<false>(o, rw, s, t * BKV, lane, Tq, Tk, a.bias, a.scale, Vs + slot * BKV * LDH);
        else
          add_pv<true>(o, rw, s, t * BKV, lane, Tq, Tk, a.bias, a.scale, Vs + slot * BKV * LDH);
      }
      __syncthreads();
    }
  }

  // one bf16 rounding of o, in pairs; rows past Tq are not stored
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    if (rw.i[hh] < Tq) {
      __nv_bfloat16* orow = a.out + ((static_cast<size_t>(b) * Tq + rw.i[hh]) * a.H + h) * D + (lane & 3) * 2;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = __floats2bfloat162_rn(o[n][2 * hh], o[n][2 * hh + 1]);
    }
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

template <FwdMode kMode>
cudaError_t launch_fwd(const FwdArgs& a, int B, int rows_per_block, int slots, cudaStream_t s) {
  const int smem = (rows_per_block + 2 * slots * BKV) * LDH * 2;
  cudaError_t err = opt_in(flash_fwd_kernel<kMode>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + rows_per_block - 1) / rows_per_block, a.H, B);
  flash_fwd_kernel<kMode><<<grid, rows_per_block * 2, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: [B, T, H, 64] views, `strides` their 9 element strides (item,
// token, head of q, then of k, then of v); out [B, Tq, H, 64] bf16 and lse
// [B, H, Tq] fp32, both contiguous; rows_per_block (kernels.flash_fwd_plan):
// the query rows of a block, a multiple of 16 up to 128, or up to 80 where
// Tk <= 64
extern "C" int vt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                      const long long* strides, const void* bias, void* out,
                                      void* lse, int B, int Tq, int Tk, int H, float scale,
                                      int rows_per_block, void* stream) {
  if (B <= 0 || Tq <= 0) return 0;
  const int max_rows = Tk <= BKV ? kOneTileMaxRows : kFwdMaxRows;
  if (Tk <= 0 || rows_per_block <= 0 || rows_per_block % 16 != 0 || rows_per_block > max_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{view(q, strides), view(k, strides + 3), view(v, strides + 6),
            static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
            static_cast<float*>(lse), Tq, Tk, H, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nkt = (Tk + BKV - 1) / BKV;
  return static_cast<int>(nkt == 1                ? launch_fwd<kOneTile>(a, B, rows_per_block, 1, s)
                          : nkt <= kResidentTiles ? launch_fwd<kResident>(a, B, rows_per_block, nkt, s)
                                                  : launch_fwd<kStreaming>(a, B, rows_per_block, 2, s));
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
