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
// Every kernel here is attention.cu's register design on the strided views:
// each warp issues `mma.sync.m16n8k16` itself (attention.cuh's `scores`,
// `fold_stats`, `add_pv`, `pv_product`), so scores, dp, p and ds stay in
// registers and are packed from the accumulators straight into the A
// fragments of the next product; fragments of staged tiles come from shared
// memory through `ldmatrix` over the 144-byte pitch, and every tile arrives
// by cp.async. No fp32 score tile exists in shared memory.
//
// Forward: one block per (query tile, head, item), its rows sized to Tq in
// warps of 16 (kernels.flash_fwd_plan: one block of 5 warps per head at the
// decoder's Tq = 77, blocks of 128 rows at T = 971). K and V of the head stay
// resident in shared memory up to 704 keys, fetched once, V behind K while
// pass 1 runs; longer keys stream through a two-slot ring, the next tile in
// flight. Where every key fits in one tile (the decoder's Tk = 61) the scaled
// scores of pass 1 stay in registers for pass 2 and are not recomputed, and
// blocks of at most 5 warps are compiled for 4 an SM, so the captioning
// step's 512 blocks run in one wave (on an H100, 14.7 us at 3 an SM against
// 11.0: the schedules are in experiments/flash_fwd_variants.py). o goes out
// from the accumulators in bf16 pairs.
//
// Backward, two kernels with no atomics (the grads are the same bits in
// every run), their blocks sized by kernels.flash_bwd_plan:
//   flash_bwd_dq   one block per (query tile, head, item), a warp per 16
//                  query rows (one block of 5 warps per head at Tq = 77).
//                  The block's q and do rows and K and V of the head are
//                  fetched once with cp.async (K and V resident up to 640
//                  keys; past that they stream through a two-slot ring, the
//                  next tile in flight); delta comes from the warp's do and o
//                  rows and is written out. Per 16 keys: q and do A fragments
//                  by `ldmatrix` (one set live at a time), s and dp as
//                  accumulators, ds packed into the A fragments of dq += ds .
//                  k. The one-tile instance (Tk <= 64) runs 4 blocks an SM,
//                  so the captioning step's 512 blocks run in one wave.
//   flash_bwd_dkv  one block per (key tile, head, item), after it, a warp
//                  per 16 keys (one block of 4 warps per head at Tk = 61),
//                  4 blocks an SM. Keys are the rows of its scores (k . q^T,
//                  v . do^T), so p^T and ds^T are A fragments of dv += p^T .
//                  do and dk += ds^T . q without a transpose; the block's k
//                  and v rows are staged once, the query tiles (q, do, lse,
//                  delta) double-buffered with cp.async, and a step past Tq
//                  is skipped (80 query rows worked at Tq = 77, not 128).
// Bias grad:
//   flash_dbias    one block of 8 warps per (64 query rows, 64 keys, chunk of
//                  items x heads of kernels.dbias_split), two an SM; warp w
//                  takes 16 rows x 32 keys. It walks its chunk in order, the
//                  next head's q, do, k and v tiles in flight while the
//                  current head's math runs, and keeps its sums of ds_raw and
//                  the bias (the same for every head) in the accumulator
//                  layout's registers; one partial [Tq, Tk] sum a chunk, then
//                  flash_dbias_reduce adds the chunks in order
//                  (kernels.flash_attention_dbias_ordered is the plain sum in
//                  this order). On the TPU the grid ran in sequence and
//                  summed in place.
// Registers (-Xptxas -v, sm_90a), no spills: dq 96 (one tile), 126
// (resident), 128 (streaming); dkv 128; dbias 128. Schedules tried, and what
// the bias grad's time is made of, are in experiments/flash_bwd_variants.py
// and PERF.md.
//
// Rounding order, as in the Pallas kernels. Forward: fp32 scores of the bf16
// q and k, times `scale`, plus the fp32 bias (each one fp32 rounding); exact
// softmax over all keys first (pass 1: row max m and row sum l; pass 2:
// p = exp(s - m) / l rounded to bf16 before p.v; an online softmax would
// rescale after p.v and round p differently); p.v accumulates in fp32 and is
// rounded to bf16 once; lse = m + log l. Backward: p = exp(s - lse) from the
// saved logsumexp (not bitwise the forward's p); delta = rowsum(do * o) from
// the rounded o (not attention_bwd.cu's sum of p * dp); ds_raw = p * (dp -
// delta); dq and dk take (ds_raw * scale) rounded to bf16, dv takes p rounded
// to bf16; dq, dk and dv are rounded to bf16 once; dbias sums the unscaled
// fp32 ds_raw over all items and heads.
//
// Bound: at Tq = 77, Tk = 61, B = 64, H = 8 (the captioning decoder's
// cross-attention) the forward moves 18 MB (q, k and v read once, o and lse
// written once): 5.4 us at 3.35 TB/s, against 0.6 GFLOP of products; the
// backward 36 MB (0.0109 ms) against 1.5 GFLOP. The work per head is one
// 64-key tile, so both are bound by the latency of their loads and by how
// many heads are in flight, not by the tensor cores; at T = 971 the
// backward's five products (0.12 ms at the bf16 peak) and its exponentials
// bound it. The bias grad (0.0061 ms of bytes at B16 T200 H12) re-reads each
// head's q, do, k and v tiles once per tile of the [Tq, Tk] grad it meets,
// from L2.
//
// Masking: keys past Tk get p = 0 against zero-filled rows; query rows past
// Tq get p = 0 and are never stored. A bias of -1e30 gives p = 0; a row
// masked everywhere gives the uniform row in the forward (m = -1e30).

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
// the backward: a dq block holds at most kFwdMaxRows query rows of q and do (kernels.flash_bwd_plan)
// and beside them K and V of the head resident up to 10 tiles of 64 keys (640 keys)
constexpr int kDqResidentTiles = (kMaxSmem - 2 * kFwdMaxRows * LDH * 2) / (2 * kTileBytes);
constexpr int kDkvMaxKeys = 64;   // keys a dkv block holds at most (kernels.FLASH_BWD_MAX_K)
constexpr int kChunk = 2;         // the backward takes its scores 2 x 8 = 16 keys (or queries) at a time
constexpr int kStatBytes = 2 * BQ * 4;                       // a query tile's lse and delta
constexpr int kDkvSlotBytes = 2 * kTileBytes + kStatBytes;   // q, do, lse, delta
constexpr int kDbiasSlotBytes = 4 * kTileBytes + kStatBytes; // q, do, k, v, lse, delta
constexpr int kDbiasThreads = 256;  // 8 warps: a 64 x 64 tile of the bias grad, 16 query rows x 32 keys a warp

// How a forward or dq block holds the keys and values of its head: every key
// in one 64-key tile (kOneTile: the forward keeps its scores in registers
// from pass 1 to pass 2; blocks of at most 5 warps, 4 an SM); all tiles
// resident in shared memory, tile t in slot t (kResident); or tiles streaming
// through two slots, tile t in slot t & 1 while tile t + 1 loads (kStreaming,
// past kResidentTiles in the forward, kDqResidentTiles in dq).
enum KvMode { kOneTile, kResident, kStreaming };

// The forward: one block of `blockDim.x / 32` warps of 16 query rows per
// (query tile of rows_per_block rows, head, item). Resident K and V are
// fetched once, V behind K, landing while pass 1 runs. The bounds: kOneTile
// blocks of at most 5 warps, 4 an SM (at most 102 registers); the others up
// to 8 warps at whatever the registers allow, so that nothing spills.
template <KvMode kMode>
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
  tile_a_frags(qf, Qs, warp * 16, lane);

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

// d[hh] = the dot product over the 64 head dims of row lane / 4 + 8 hh of
// two sets of A fragments of the same 16 rows (do and o): a lane's 16
// columns in a fixed order, then the quad's four lanes, so every lane of the
// quad holds the same bits
__device__ __forceinline__ void row_dots(float (&d)[2], const uint32_t (&x)[4][4],
                                         const uint32_t (&y)[4][4]) {
  d[0] = d[1] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // registers 0 and 2 hold row lane / 4, 1 and 3 row lane / 4 + 8
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[kk][e]));
      const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y[kk][e]));
      d[e & 1] += a.x * c.x;
      d[e & 1] += a.y * c.y;
    }
  d[0] = quad_sum(d[0]);
  d[1] = quad_sum(d[1]);
}

// a warp's 16 x 64 fp32 result (rows i[0], i[1] of the lane) rounded once to
// bf16 into head h of dst [B, T, H, 64], in pairs; rows past T skipped
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&f)[8][4], const int (&i)[2],
                                           int b, int h, int T, int H, int lane) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    if (i[hh] < T) {
      __nv_bfloat16* row = dst + ((static_cast<size_t>(b) * T + i[hh]) * H + h) * D + (lane & 3) * 2;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(row + n * 8) = __floats2bfloat162_rn(f[n][2 * hh], f[n][2 * hh + 1]);
    }
}

// rows [q0, q0 + 64) of the lse and delta [B*H, Tq] of one head (from
// stat0), asynchronously, by the block's `threads` threads; rows past Tq are 0
__device__ __forceinline__ void stage_stats(float* st, const float* lse, const float* delta,
                                            size_t stat0, int q0, int Tq, int threads) {
  for (int e = threadIdx.x; e < 2 * BQ; e += threads) {
    const int r = e % BQ;
    const bool in = q0 + r < Tq;
    cp_async4(st + e, (e < BQ ? lse : delta) + (in ? stat0 + q0 + r : 0), in);
  }
}

// dq. The block's q and do rows are staged beside K and V and read into A
// fragments for each step of 16 keys (in registers they would cap the
// one-tile instance at 3 blocks an SM). The bounds: kOneTile blocks of at
// most 5 warps, 4 an SM (at most 102 registers); the others up to 8 warps,
// two an SM (128 registers).
template <KvMode kMode>
__global__ void __launch_bounds__((kMode == kOneTile ? kOneTileMaxRows : kFwdMaxRows) * 2,
                                  kMode == kOneTile ? 4 : 2)
flash_bwd_dq_kernel(BwdArgs a) {
  constexpr bool kAll = kMode != kStreaming;  // every key tile resident
  extern __shared__ __align__(128) unsigned char smem[];
  const int threads = blockDim.x, rows = threads / 2;  // 16 query rows a warp
  const int Tq = a.Tq, Tk = a.Tk, nkt = kMode == kOneTile ? 1 : (Tk + BKV - 1) / BKV;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + rows * LDH;
  __nv_bfloat16* Ks = dOs + rows * LDH;
  __nv_bfloat16* Vs = Ks + (kAll ? nkt : 2) * BKV * LDH;

  const int q0 = blockIdx.x * rows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, r0 = q0 + warp * 16;
  const __nv_bfloat16* kbase = a.k.head(b, h);
  const __nv_bfloat16* vbase = a.v.head(b, h);
  const int kst = static_cast<int>(a.k.st), vst = static_cast<int>(a.v.st);
  const bool active = r0 < Tq;  // else: every row of this warp is past Tq

  stage_rows(Qs, a.q.head(b, h), q0, rows, Tq, static_cast<int>(a.q.st), threads);
  stage_rows(dOs, a.dout.head(b, h), q0, rows, Tq, static_cast<int>(a.dout.st), threads);
  const int kv_rows = kAll ? nkt * BKV : BKV;
  stage_rows(Ks, kbase, 0, kv_rows, Tk, kst, threads);
  stage_rows(Vs, vbase, 0, kv_rows, Tk, vst, threads);
  cp_async_commit();

  // while they land: this warp's o rows and lse
  uint32_t of[4][4];
  load_a_frags(of, a.o.head(b, h), r0, Tq, static_cast<int>(a.o.st), lane);
  int i[2];
  float lse[2], delta[2];
  const size_t stat0 = (static_cast<size_t>(b) * a.H + h) * Tq;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    i[hh] = r0 + (lane >> 2) + 8 * hh;
    lse[hh] = i[hh] < Tq ? a.lse[stat0 + i[hh]] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  {
    uint32_t dof[4][4];
    tile_a_frags(dof, dOs, warp * 16, lane);
    row_dots(delta, dof, of);  // delta = rowsum(do * o), from the rounded o
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    if ((lane & 3) == 0 && i[hh] < Tq) a.delta[stat0 + i[hh]] = delta[hh];

  float dq[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  float s[kChunk][4], dp[kChunk][4];
  for (int t = 0; t < nkt; ++t) {
    if constexpr (!kAll) {
      // slot (t + 1) & 1 was last read at tile t - 1, before that tile's closing barrier
      if (t + 1 < nkt) {
        stage_rows(Ks + ((t + 1) & 1) * BKV * LDH, kbase, (t + 1) * BKV, BKV, Tk, kst, threads);
        stage_rows(Vs + ((t + 1) & 1) * BKV * LDH, vbase, (t + 1) * BKV, BKV, Tk, vst, threads);
      }
      cp_async_commit();  // possibly empty: "all but the newest group" is tile t
      cp_async_wait<1>();
      __syncthreads();
    }
    if (active) {
      const int slot = kAll ? t : t & 1;
#pragma unroll
      for (int c = 0; c < BKV / (8 * kChunk) && t * BKV + c * 8 * kChunk < Tk; ++c) {
        const int off = (slot * BKV + c * 8 * kChunk) * LDH;
        {  // one set of fragments live at a time: ldmatrix and mma keep their order
          uint32_t f[4][4];
          tile_a_frags(f, Qs, warp * 16, lane);
          scores(s, f, Ks + off, lane);
          tile_a_frags(f, dOs, warp * 16, lane);
          scores(dp, f, Vs + off, lane);
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = t * BKV + (c * kChunk + j) * 8 + (lane & 3) * 2 + (e & 1), hh = e >> 1;
            float ds = 0.f;
            if (col < Tk && i[hh] < Tq) {
              const float p = prob_lse(scaled(s[j][e], a.scale, a.bias, i[hh], col, Tq, Tk), lse[hh]);
              ds = __fmul_rn(ds_raw(p, dp[j][e], delta[hh]), a.scale);
            }
            s[j][e] = ds;
          }
        pv_product(dq, s, Ks + off, lane);  // dq += bf16(ds) . k over these 16 keys
      }
    }
    if constexpr (!kAll) __syncthreads();
  }
  store_rows(a.dq, dq, i, b, h, Tq, a.H, lane);
}

// the query tile [q0, q0 + 64) of one head into one slot: q and do rows, then
// lse and delta
__device__ __forceinline__ void stage_query_tile(const BwdArgs& a, unsigned char* slot, int b, int h,
                                                 int q0, int threads) {
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(slot);
  stage_rows(Qs, a.q.head(b, h), q0, BQ, a.Tq, static_cast<int>(a.q.st), threads);
  stage_rows(Qs + BQ * LDH, a.dout.head(b, h), q0, BQ, a.Tq, static_cast<int>(a.dout.st), threads);
  stage_stats(reinterpret_cast<float*>(slot + 2 * kTileBytes), a.lse, a.delta,
              (static_cast<size_t>(b) * a.H + h) * a.Tq, q0, a.Tq, threads);
}

// dk and dv: blocks of up to 4 warps, four an SM (at most 128 registers). The
// block's k and v rows are staged after the two query slots and read into A
// fragments for each step of 16 queries.
__global__ void __launch_bounds__(kDkvMaxKeys * 2, 4) flash_bwd_dkv_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int threads = blockDim.x, keys = threads / 2;  // 16 keys a warp
  const int Tq = a.Tq, Tk = a.Tk, nqt = (Tq + BQ - 1) / BQ;
  const int k0 = blockIdx.x * keys, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, r0 = k0 + warp * 16;
  const bool active = r0 < Tk;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + 2 * kDkvSlotBytes);
  __nv_bfloat16* Vs = Ks + keys * LDH;

  stage_rows(Ks, a.k.head(b, h), k0, keys, Tk, static_cast<int>(a.k.st), threads);
  stage_rows(Vs, a.v.head(b, h), k0, keys, Tk, static_cast<int>(a.v.st), threads);
  stage_query_tile(a, smem, b, h, 0, threads);
  cp_async_commit();
  const int key[2] = {r0 + (lane >> 2), r0 + (lane >> 2) + 8};

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  float sT[kChunk][4], dpT[kChunk][4];  // keys are the rows: sT[j] holds queries 8 j .. 8 j + 7

  for (int t = 0; t < nqt; ++t) {
    // slot (t + 1) & 1 was last read at tile t - 1, before that tile's closing barrier
    if (t + 1 < nqt) stage_query_tile(a, smem + ((t + 1) & 1) * kDkvSlotBytes, b, h, (t + 1) * BQ, threads);
    cp_async_commit();  // possibly empty: "all but the newest group" is tile t
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const unsigned char* slot = smem + (t & 1) * kDkvSlotBytes;
      const __nv_bfloat16* Qs = reinterpret_cast<const __nv_bfloat16*>(slot);
      const __nv_bfloat16* dOs = Qs + BQ * LDH;
      const float* st = reinterpret_cast<const float*>(slot + 2 * kTileBytes);  // lse, delta
#pragma unroll
      for (int c = 0; c < BQ / (8 * kChunk) && t * BQ + c * 8 * kChunk < Tq; ++c) {
        {  // one set of fragments live at a time: ldmatrix and mma keep their order
          uint32_t f[4][4];
          tile_a_frags(f, Ks, warp * 16, lane);
          scores(sT, f, Qs + c * 8 * kChunk * LDH, lane);
          tile_a_frags(f, Vs, warp * 16, lane);
          scores(dpT, f, dOs + c * 8 * kChunk * LDH, lane);
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = (c * kChunk + j) * 8 + (lane & 3) * 2 + (e & 1), qi = t * BQ + r;
            const int kj = key[e >> 1];
            float p = 0.f, ds = 0.f;
            if (qi < Tq && kj < Tk) {
              p = prob_lse(scaled(sT[j][e], a.scale, a.bias, qi, kj, Tq, Tk), st[r]);
              ds = __fmul_rn(ds_raw(p, dpT[j][e], st[BQ + r]), a.scale);
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
  store_rows(a.dk, dk, key, b, h, Tk, a.H, lane);
  store_rows(a.dv, dv, key, b, h, Tk, a.H, lane);
}

// one (item, head) pair of a bias-grad block's chunk into one slot: rows
// [q0, q0 + 64) of q and do, keys [k0, k0 + 64) of k and v, then lse and delta
__device__ __forceinline__ void stage_dbias_head(const DbiasArgs& a, unsigned char* slot, int bh, int q0,
                                                 int k0) {
  const int b = bh / a.H, h = bh % a.H;
  __nv_bfloat16* t = reinterpret_cast<__nv_bfloat16*>(slot);
  stage_rows(t, a.q.head(b, h), q0, BQ, a.Tq, static_cast<int>(a.q.st), kDbiasThreads);
  stage_rows(t + BQ * LDH, a.dout.head(b, h), q0, BQ, a.Tq, static_cast<int>(a.dout.st), kDbiasThreads);
  stage_rows(t + 2 * BQ * LDH, a.k.head(b, h), k0, BKV, a.Tk, static_cast<int>(a.k.st), kDbiasThreads);
  stage_rows(t + 3 * BQ * LDH, a.v.head(b, h), k0, BKV, a.Tk, static_cast<int>(a.v.st), kDbiasThreads);
  stage_stats(reinterpret_cast<float*>(slot + 4 * kTileBytes), a.lse, a.delta,
              static_cast<size_t>(bh) * a.Tq, q0, a.Tq, kDbiasThreads);
}

// two blocks of 8 warps an SM (at most 128 registers, 2 x 73 KB of shared
// memory); warp w takes rows 16 (w % 4) .. + 15 of the tile against keys
// 32 (w / 4) .. + 31
constexpr int kDbiasKeys = 32;  // keys of a warp
__global__ void __launch_bounds__(kDbiasThreads, 2) flash_dbias_kernel(DbiasArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = blockIdx.x * BQ, k0 = blockIdx.y * BKV, chunk = blockIdx.z;
  const int Tq = a.Tq, Tk = a.Tk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = (warp & 3) * 16, kw = k0 + (warp >> 2) * kDbiasKeys;  // the warp's rows and keys
  const bool active = q0 + rg < Tq && kw < Tk;
  const int ri = rg + (lane >> 2);  // the lane's rows ri and ri + 8 of the tile
  const int i[2] = {q0 + ri, q0 + ri + 8};
  const int bh0 = chunk * a.per_chunk, bh1 = min(bh0 + a.per_chunk, a.BH);

  // the warp's 16 rows x 32 keys in the accumulator layout: the sums, and the bias, the same for
  // every head (0 past Tq or Tk)
  float sum[kDbiasKeys / 8][4], bv[kDbiasKeys / 8][4];
#pragma unroll
  for (int j = 0; j < kDbiasKeys / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = kw + j * 8 + (lane & 3) * 2 + (e & 1), hh = e >> 1;
      sum[j][e] = 0.f;
      bv[j][e] = a.bias != nullptr && col < Tk && i[hh] < Tq ? a.bias[static_cast<size_t>(i[hh]) * Tk + col] : 0.f;
    }
  if (bh0 < bh1) stage_dbias_head(a, smem, bh0, q0, k0);
  cp_async_commit();
  float s[kChunk][4], dp[kChunk][4];
  for (int bh = bh0; bh < bh1; ++bh) {  // in order: the sum is the same in every run
    const int n = bh - bh0;
    // slot (n + 1) & 1 was last read at head n - 1, before that head's closing barrier
    if (bh + 1 < bh1) stage_dbias_head(a, smem + ((n + 1) & 1) * kDbiasSlotBytes, bh + 1, q0, k0);
    cp_async_commit();  // possibly empty: "all but the newest group" is head n
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const unsigned char* slot = smem + (n & 1) * kDbiasSlotBytes;
      const __nv_bfloat16* Qs = reinterpret_cast<const __nv_bfloat16*>(slot);
      const __nv_bfloat16* dOs = Qs + BQ * LDH;
      const __nv_bfloat16* Ks = dOs + BQ * LDH + (kw - k0) * LDH;  // the warp's keys of the k and v tiles
      const __nv_bfloat16* Vs = Ks + BKV * LDH;
      const float* st = reinterpret_cast<const float*>(slot + 4 * kTileBytes);  // lse, delta
      uint32_t qf[4][4], dof[4][4];
      tile_a_frags(qf, Qs, rg, lane);
      tile_a_frags(dof, dOs, rg, lane);
      const float lse[2] = {st[ri], st[ri + 8]}, delta[2] = {st[BQ + ri], st[BQ + ri + 8]};
#pragma unroll
      for (int c = 0; c < kDbiasKeys / (8 * kChunk); ++c) {
        if (kw + c * 8 * kChunk >= Tk) break;
        scores(s, qf, Ks + c * 8 * kChunk * LDH, lane);
        scores(dp, dof, Vs + c * 8 * kChunk * LDH, lane);
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kw + (c * kChunk + j) * 8 + (lane & 3) * 2 + (e & 1), hh = e >> 1;
            if (col < Tk && i[hh] < Tq) {
              const float p = prob_lse(scaled(s[j][e], a.scale, bv[c * kChunk + j][e]), lse[hh]);
              sum[c * kChunk + j][e] = __fadd_rn(sum[c * kChunk + j][e], ds_raw(p, dp[j][e], delta[hh]));
            }
          }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kDbiasKeys / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = kw + j * 8 + (lane & 3) * 2 + (e & 1), hh = e >> 1;
      if (col < Tk && i[hh] < Tq) a.partial[(static_cast<size_t>(chunk) * Tq + i[hh]) * Tk + col] = sum[j][e];
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

template <KvMode kMode>
cudaError_t launch_fwd(const FwdArgs& a, int B, int rows_per_block, int slots, cudaStream_t s) {
  const int smem = (rows_per_block + 2 * slots * BKV) * LDH * 2;
  cudaError_t err = opt_in(flash_fwd_kernel<kMode>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + rows_per_block - 1) / rows_per_block, a.H, B);
  flash_fwd_kernel<kMode><<<grid, rows_per_block * 2, smem, s>>>(a);
  return cudaGetLastError();
}

template <KvMode kMode>
cudaError_t launch_dq(const BwdArgs& a, int B, int rows_per_block, int slots, cudaStream_t s) {
  const int smem = 2 * (rows_per_block + slots * BKV) * LDH * 2;
  cudaError_t err = opt_in(flash_bwd_dq_kernel<kMode>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + rows_per_block - 1) / rows_per_block, a.H, B);
  flash_bwd_dq_kernel<kMode><<<grid, rows_per_block * 2, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

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
// dq [B, Tq, H, 64], dk and dv [B, Tk, H, 64] bf16, contiguous;
// kernels.flash_bwd_plan: q_rows, the query rows of a dq block (a multiple
// of 16 up to 128, or up to 80 where Tk <= 64), k_rows, the keys of a dkv
// block (a multiple of 16 up to 64)
extern "C" int vt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const long long* strides, const void* bias, const void* o,
                                      const void* lse, const void* dout, void* delta, void* dq,
                                      void* dk, void* dv, int B, int Tq, int Tk, int H,
                                      float scale, int q_rows, int k_rows, void* stream) {
  if (B <= 0 || Tq <= 0) return 0;
  const int max_rows = Tk <= BKV ? kOneTileMaxRows : kFwdMaxRows;
  if (Tk <= 0 || q_rows <= 0 || q_rows % 16 != 0 || q_rows > max_rows || k_rows <= 0 ||
      k_rows % 16 != 0 || k_rows > kDkvMaxKeys)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{view(q, strides), view(k, strides + 3), view(v, strides + 6), dense(o, Tq, H),
            dense(dout, Tq, H), static_cast<const float*>(bias), static_cast<const float*>(lse),
            static_cast<float*>(delta), static_cast<__nv_bfloat16*>(dq),
            static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Tq, Tk, H, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nkt = (Tk + BKV - 1) / BKV;
  cudaError_t err = nkt == 1                 ? launch_dq<kOneTile>(a, B, q_rows, 1, s)
                    : nkt <= kDqResidentTiles ? launch_dq<kResident>(a, B, q_rows, nkt, s)
                                              : launch_dq<kStreaming>(a, B, q_rows, 2, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dkv_smem = 2 * kDkvSlotBytes + 2 * k_rows * LDH * 2;
  err = opt_in(flash_bwd_dkv_kernel, dkv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<<<dim3((Tk + k_rows - 1) / k_rows, H, B), k_rows * 2, dkv_smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dbias [Tq, Tk] fp32 = sum over items and heads of ds_raw, from the lse of
// the forward and the delta of vt_flash_attention_bwd; kernels.dbias_split:
// chunk c takes the (item, head) pairs [c * per_chunk, c * per_chunk +
// per_chunk), none empty; partial: scratch [chunks, Tq, Tk] fp32
extern "C" int vt_flash_attention_dbias(const void* q, const void* k, const void* v,
                                        const long long* strides, const void* bias,
                                        const void* lse, const void* delta, const void* dout,
                                        void* partial, void* dbias, int B, int Tq, int Tk, int H,
                                        float scale, int chunks, int per_chunk, void* stream) {
  if (B <= 0 || Tq <= 0) return 0;
  const int BH = B * H;
  if (Tk <= 0 || chunks <= 0 || per_chunk <= 0 || (chunks - 1) * per_chunk >= BH ||
      chunks * per_chunk < BH)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kDbiasSmem = 2 * kDbiasSlotBytes;
  cudaError_t err = opt_in(flash_dbias_kernel, kDbiasSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  DbiasArgs a{view(q, strides), view(k, strides + 3), view(v, strides + 6), dense(dout, Tq, H),
              static_cast<const float*>(bias), static_cast<const float*>(lse),
              static_cast<const float*>(delta), static_cast<float*>(partial), Tq, Tk, H, BH,
              per_chunk, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  flash_dbias_kernel<<<dim3((Tq + BQ - 1) / BQ, (Tk + BKV - 1) / BKV, chunks), kDbiasThreads,
                       kDbiasSmem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(Tq) * Tk;
  flash_dbias_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dbias), chunks, n);
  return static_cast<int>(cudaGetLastError());
}
