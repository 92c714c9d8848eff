// attention_fwd: softmax(q.k^T * scale + bias) . v for every head, reading
// the packed [B, T, 3C] projection and writing [B, T, C]; for training also
// the softmax's row max and row sum, which attention_bwd reads.
//
// Replaces: the score / softmax / context steps of the Pallas kernel
//   vipant_tpu/ops/fused_attn.py::_fwd_kernel (lines 105-111).
// On the TPU one grid step held all heads' [H, T, T] scores in VMEM. A
// Hopper block has 227 KB of shared memory and many blocks must be in
// flight, so the work is cut into one block per (query tile, head, item)
// and the keys are streamed through shared memory in tiles of 64.
//
// Bound: at T ~ 300 and D = 64 the products are small (2*T*T*D per head
// and pass); the kernel is bound by latency and shared-memory traffic more
// than by the tensor cores. Scores are computed twice (one pass for the
// statistics, one for the probabilities), which costs one extra q.k^T
// product per tile and keeps no [T, T] array anywhere.
//
// Rounding order, as in the Pallas kernel: scores are fp32 products of the
// bf16 q and k, multiplied by `scale`, then the fp32 bias is added; the
// softmax is exact (row max and sum in fp32 over all keys first, then
// p = exp(s - max) / sum) and p is rounded to bf16 before p.v, which
// accumulates in fp32 and is rounded to bf16 once. A flash-style online
// softmax would rescale after p.v and so round p differently.
//
// Layout and masking: see attention.cuh. Keys past T get probability 0
// against zero-filled v rows; query rows past T are not stored.
//
// attention_fwd_f32 is the same kernel with the context stored in fp32,
// unrounded: the int8 sub-block (vipant_tpu/ops/fused_attn.py::
// _fwd_int8_kernel, lines 155-158) quantizes the context from fp32, with one
// scale per token over all heads, which no (query tile, head) block holds;
// quant.cu's rowquant reads it back.

#include "attention.cuh"

namespace {

using namespace attn;

constexpr int kSmemBytes = 4 * kTileBytes + kScoreBytes;

__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ bias,
                     OutT* __restrict__ out, float* __restrict__ stat_m,
                     float* __restrict__ stat_l, int T, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * LDH;
  __nv_bfloat16* Vs = Ks + BKV * LDH;
  __nv_bfloat16* Ps = Vs + BKV * LDH;
  float* Ss = reinterpret_cast<float*>(Ps + BQ * LDH);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D, C3 = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16* item = qkv + static_cast<size_t>(b) * T * C3;
  const __nv_bfloat16* qbase = item + h * D;
  const __nv_bfloat16* kbase = item + C + h * D;
  const __nv_bfloat16* vbase = item + 2 * C + h * D;

  // each lane owns half of one of the warp's 16 rows
  const int r = lane >> 1, half = lane & 1;
  const int i = q0 + warp * 16 + r;  // global query index
  float* srow = Ss + (warp * 16 + r) * LDS + half * 32;
  __nv_bfloat16* prow = Ps + (warp * 16 + r) * LDH + half * 32;

  load_rows(Qs, qbase, q0, T, C3);
  const int nkt = (T + BKV - 1) / BKV;

  // pass 1: row max and row sum over all keys
  float m = -INFINITY, l = 0.f;
  for (int t = 0; t < nkt; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // previous tile's readers are done with Ks
    load_rows(Ks, kbase, k0, T, C3);
    __syncthreads();
    score_tile(Qs, Ks, Ss, warp);
    float tmax = -INFINITY;
    for (int c = 0; c < 32; ++c) {
      const int j = k0 + half * 32 + c;
      if (j < T) {
        const float s = scaled(srow[c], scale, bias, i, j, T);
        srow[c] = s;
        tmax = fmaxf(tmax, s);
      }
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float mnew = fmaxf(m, tmax);
    float tsum = 0.f;
    for (int c = 0; c < 32; ++c) {
      const int j = k0 + half * 32 + c;
      if (j < T) tsum += expf(srow[c] - mnew);
    }
    tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
    l = l * expf(m - mnew) + tsum;  // m = -inf on the first tile: exp(-inf) = 0
    m = mnew;
    __syncwarp();
  }
  if (stat_m != nullptr && i < T && half == 0) {
    const size_t row = (static_cast<size_t>(b) * H + h) * T + i;
    stat_m[row] = m;
    stat_l[row] = l;
  }

  // pass 2: normalised bf16 p, then p.v accumulated in fp32
  FragC o[D / 16];
#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj) wmma::fill_fragment(o[dj], 0.f);
  for (int t = 0; t < nkt; ++t) {
    const int k0 = t * BKV;
    __syncthreads();
    load_rows(Ks, kbase, k0, T, C3);
    load_rows(Vs, vbase, k0, T, C3);
    __syncthreads();
    score_tile(Qs, Ks, Ss, warp);
    for (int c = 0; c < 32; ++c) {
      const int j = k0 + half * 32 + c;
      float p = 0.f;
      if (j < T) p = prob(scaled(srow[c], scale, bias, i, j, T), m, l);
      prow[c] = __float2bfloat16(p);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BKV; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, Ps + warp * 16 * LDH + kk, LDH);
#pragma unroll
      for (int dj = 0; dj < D / 16; ++dj) {
        FragBr vb;
        wmma::load_matrix_sync(vb, Vs + kk * LDH + dj * 16, LDH);
        wmma::mma_sync(o[dj], a, vb, o[dj]);
      }
    }
  }

  // o (fp32) -> the warp's rows of Ss -> out (one bf16 rounding, or fp32 as it is)
#pragma unroll
  for (int dj = 0; dj < D / 16; ++dj)
    wmma::store_matrix_sync(Ss + warp * 16 * LDS + dj * 16, o[dj], LDS, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * D; e += 32) {
    const int rr = e / D, d = e % D;
    const int qi = q0 + warp * 16 + rr;
    if (qi < T)
      store_out(out + (static_cast<size_t>(b) * T + qi) * C + h * D + d,
                Ss[(warp * 16 + rr) * LDS + d]);
  }
}

template <typename OutT>
int launch(const void* qkv, const void* bias, void* out, void* stats, int B, int T, int H,
           float scale, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* stat_m = static_cast<float*>(stats);
  float* stat_l = stat_m == nullptr ? nullptr : stat_m + static_cast<size_t>(B) * H * T;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  attention_fwd_kernel<OutT><<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(bias),
      static_cast<OutT*>(out), stat_m, stat_l, T, H, scale);
  return static_cast<int>(cudaGetLastError());
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
