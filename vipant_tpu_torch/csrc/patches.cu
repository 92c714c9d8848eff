// patch_gather: the patches of a ViT patch embedding (im2col) in F.unfold's layout, which
// ops/patches.py multiplies by the flattened OIHW conv weight through their transposed view.
//
//   out[b, (c * ph + i) * pw + j, l] = x[b, c, r * sh + i, q * sw + j],   l = r * ncol + q
//
// x [B, Cin, H, W] fp32 or bf16, read through its strides (the device frontend hands over a
// view cropped in time); out [B, K = Cin * ph * pw, L = nrow * ncol] contiguous, bf16 or fp32,
// rounded to nearest even as Tensor.to rounds, so a bf16 out is bitwise
// F.unfold(x.to(bfloat16)). Patches may overlap (the audio grid: 32 x 32 at a stride of
// 16 x 24). The layout is F.unfold's so that the product is handed the operand it had before,
// a transposed view of [B, K, L], and cuBLAS picks the algorithm, and gives the bits, it gave
// then: a [B, L, K] operand takes another algorithm and moves the training losses.
//
// Replaces: no Pallas kernel. The JAX package leaves patch extraction to XLA
// (vipant_tpu/ops/patches.py: reshapes and slices that XLA folds into the product's
// dot_general). It was written because PyTorch's F.unfold launches its im2col kernel once
// per batch item with only Cin * nrow * ncol threads (305 for the audio grid, 147 for the
// image grid), each writing Cin * ph * pw strided values in turn: about 72 us a launch on the
// H100 whatever the shape, 864 launches and 64 ms of a VA training step at B = 432, and a
// separate pass before it to round the fp32 input to bf16.
//
// Bound: memory. The input read once and the patches written once: at B = 432 the fp32
// fbanks [432, 1, 1000, 128] (221 MB) and frames [432, 3, 224, 224] (260 MB), and the bf16
// patches [432, 1024, 305] (270 MB) and [432, 3072, 49] (130 MB): 881 MB, 0.26 ms at
// 3.35 TB/s.
//
// Design: one launch for the whole batch. What makes a gather slow here is that neighbouring
// outputs (l, l + 1) lie sw values apart in the input, and neighbouring inputs (j, j + 1) lie L
// outputs apart, so either the reads or the writes scatter. So each block takes one patch row
// i of one channel c of one item b, over a chunk of grid rows r, and stages through shared
// memory: it reads the input rows r * sh + i of the chunk whole, consecutive threads on
// consecutive columns (coalesced; rounded to the output's dtype on the way), then writes the
// pw output rows (c, i, j) of those grid cells, consecutive threads on consecutive l
// (coalesced), each value read from shared memory at a table's offset of l plus j. The rows
// are padded by one 4-byte word, so the lanes of a warp, which span a few input rows at the
// same columns, fall in different banks. Overlapping patches (the audio grid: a stride of 16
// on a height of 32) read an input row in two blocks a few blocks apart, so the second read
// comes from L2. The chunk is sized from the shapes so that a block's shared memory stays
// near 24 KB (the audio grid: one chunk of 61 rows, 17 KB; DeiT's: two), for eight blocks of
// 256 threads an SM; nothing else is tuned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemTarget = 24 * 1024;  // bytes a block aims at
constexpr int kSmemMax = 48 * 1024;     // bytes a block may take without opting in

struct Shape {
  long long stride_b, stride_c, stride_h, stride_w;  // x's, in elements
  int Cin, ph, pw, sh, sw, nrow, ncol, L;
  int Wu;       // the columns the patches read: (ncol - 1) * sw + pw
  int S;        // a staged row's length in shared memory: Wu and one 4-byte word
  int R;        // grid rows a block takes
  int nchunks;  // blocks a patch row i of a channel: ceil(nrow / R)
};

__device__ __forceinline__ void cvt(float v, __nv_bfloat16* o) { *o = __float2bfloat16_rn(v); }
__device__ __forceinline__ void cvt(float v, float* o) { *o = v; }
__device__ __forceinline__ void cvt(__nv_bfloat16 v, __nv_bfloat16* o) { *o = v; }
__device__ __forceinline__ void cvt(__nv_bfloat16 v, float* o) { *o = __bfloat162float(v); }

// block (b, c, i, chunk) writes out[b, (c * ph + i) * pw + j, r * ncol + q] for every j and q
// and the chunk's grid rows r
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
patch_gather_kernel(const Tin* __restrict__ x, Tout* __restrict__ out, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  int blk = blockIdx.x;
  const int chunk = blk % s.nchunks;
  blk /= s.nchunks;
  const int i = blk % s.ph;
  blk /= s.ph;
  const int c = blk % s.Cin;
  const long long b = blk / s.Cin;
  const int r0 = chunk * s.R, R = min(s.R, s.nrow - r0), RL = R * s.ncol;
  int* offs = reinterpret_cast<int*>(smem);                   // [RL]: where output column l starts
  Tout* rows = reinterpret_cast<Tout*>(smem + RL * sizeof(int));  // [R, S]: the input rows

  const Tin* src = x + b * s.stride_b + c * s.stride_c + static_cast<long long>(r0 * s.sh + i) * s.stride_h;
  {  // element e of the chunk's R x Wu, e = threadIdx.x + kThreads * n, walked by increments
    const int rstep = kThreads / s.Wu, wstep = kThreads - rstep * s.Wu;
    int rr = threadIdx.x / s.Wu, w = threadIdx.x - rr * s.Wu;
    while (rr < R) {
      cvt(__ldg(src + static_cast<long long>(rr * s.sh) * s.stride_h + static_cast<long long>(w) * s.stride_w),
          rows + rr * s.S + w);
      rr += rstep;
      w += wstep;
      if (w >= s.Wu) w -= s.Wu, ++rr;
    }
  }
  for (int l = threadIdx.x; l < RL; l += kThreads) {
    const int rr = l / s.ncol;
    offs[l] = rr * s.S + (l - rr * s.ncol) * s.sw;
  }
  __syncthreads();

  Tout* dst = out + ((b * s.Cin + c) * s.ph + i) * s.pw * static_cast<long long>(s.L) +
              static_cast<long long>(r0) * s.ncol;
  // element e of the block's pw x RL outputs, walked as above
  const int jstep = kThreads / RL, lstep = kThreads - jstep * RL;
  int j = threadIdx.x / RL, l = threadIdx.x - j * RL;
  while (j < s.pw) {
    dst[static_cast<long long>(j) * s.L + l] = rows[offs[l] + j];
    j += jstep;
    l += lstep;
    if (l >= RL) l -= RL, ++j;
  }
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* x, void* out, int B, Shape s, cudaStream_t stream) {
  s.S = s.Wu + 4 / static_cast<int>(sizeof(Tout));
  const int row_bytes = s.S * static_cast<int>(sizeof(Tout)) + s.ncol * static_cast<int>(sizeof(int));
  if (row_bytes > kSmemMax) return cudaErrorInvalidValue;
  const int r_max = kSmemTarget / row_bytes > 1 ? kSmemTarget / row_bytes : 1;
  s.nchunks = (s.nrow + r_max - 1) / r_max;
  s.R = (s.nrow + s.nchunks - 1) / s.nchunks;  // even chunks
  const long long blocks = static_cast<long long>(B) * s.Cin * s.ph * s.nchunks;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  patch_gather_kernel<Tin, Tout><<<static_cast<unsigned>(blocks), kThreads, s.R * row_bytes, stream>>>(
      static_cast<const Tin*>(x), static_cast<Tout*>(out), s);
  return cudaGetLastError();
}

}  // namespace

// out [B, Cin * ph * pw, L] (fp32 if out_f32, else bf16, contiguous) = the patches of x
// [B, Cin, H, W] (fp32 if x_f32, else bf16) at element strides (xb, xc, xh, xw); B >= 1,
// 0 < ph <= H, 0 < pw <= W <= 4096, patch strides sh, sw >= 1
extern "C" int vt_patch_gather(const void* x, int x_f32, long long xb, long long xc, long long xh,
                               long long xw, void* out, int out_f32, int B, int Cin, int H, int W, int ph,
                               int pw, int sh, int sw, void* stream) {
  if (B < 1 || Cin < 1 || ph < 1 || pw < 1 || ph > H || pw > W || W > 4096 || sh < 1 || sw < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nrow = (H - ph) / sh + 1, ncol = (W - pw) / sw + 1;
  const Shape s{xb, xc, xh, xw, Cin, ph, pw, sh, sw, nrow, ncol, nrow * ncol, (ncol - 1) * sw + pw, 0, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return static_cast<int>(out_f32 ? launch<float, float>(x, out, B, s, st)
                                    : launch<float, __nv_bfloat16>(x, out, B, s, st));
  return static_cast<int>(out_f32 ? launch<__nv_bfloat16, float>(x, out, B, s, st)
                                  : launch<__nv_bfloat16, __nv_bfloat16>(x, out, B, s, st));
}
