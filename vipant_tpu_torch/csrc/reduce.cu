// colsum: fp32 sums over the rows of a [rows, N] bf16 or fp32 matrix -- the
// bias grads of the backward chains (dbout, dbqkv, dbproj, dbfc).
//
// Replaces: the `jnp.sum(..., axis=0)` bias-grad accumulations inside the
// Pallas kernels vipant_tpu/ops/fused_attn.py::_bwd_kernel (dbout, line 217;
// dbqkv, line 229) and vipant_tpu/ops/fused_mlp.py::_bwd_kernel (dbproj,
// line 78; dbfc, line 82), which the TPU summed over its sequential grid.
//
// Bound: memory; one read of the matrix (30 MB for a bf16 [19,584, 768]
// bias grad of the training step, 9 us at 3.35 TB/s), a few partial rows
// written and read back.
//
// Design: wide strips, a planned row split, partials added in a fixed order,
// no atomics (the same bits in every run). A lane reads 16 bytes of a row (8
// bf16 or 4 fp32), so a warp reads 512 contiguous bytes: a strip of 256 bf16
// or 128 fp32 columns, whole 128-byte lines. A block of 8 warps owns one strip
// and one chunk of rows; warp w sums rows w, w + 8, w + 16, ... of the chunk
// in order, 8 rows in flight a lane, and the block adds its warps' sums in
// warp order through shared memory into its partial row. The chunks come from
// `colsum_split` in ops/kernels.py, which gives the training step's shapes a
// few blocks an SM (the strips alone are 2 to 18 blocks). A second launch of
// the same kernel sums the S partial rows as an fp32 [S, N] matrix in one
// chunk: 128 columns a block, warp w adding partial rows w, w + 8, ... (11 rows
// a lane at S = 88), then the warps in order; at N = 768 six blocks, a few us.
// Two launches and not a cluster of blocks adding through distributed shared
// memory: a cluster spans at most 16 blocks, and at N = 512 or 768 (two or
// three strips) 16 chunks put 32 to 48 blocks on a card of 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;   // warps a block; each takes every 8th row of the block's chunk
constexpr int kUnroll = 8;  // rows a lane has in flight

template <typename T>
constexpr int kVec = 16 / sizeof(T);  // elements a lane reads at once: 8 bf16 or 4 fp32

// s[k] += the k-th value of the 16 bytes v, read as the type of the pointer
__device__ __forceinline__ void add16(const uint4& v, const __nv_bfloat16*, float (&s)[8]) {
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s[2 * k] = __fadd_rn(s[2 * k], __uint_as_float(u[k] << 16));
    s[2 * k + 1] = __fadd_rn(s[2 * k + 1], __uint_as_float(u[k] & 0xffff0000u));
  }
}

__device__ __forceinline__ void add16(const uint4& v, const float*, float (&s)[4]) {
  s[0] = __fadd_rn(s[0], __uint_as_float(v.x));
  s[1] = __fadd_rn(s[1], __uint_as_float(v.y));
  s[2] = __fadd_rn(s[2], __uint_as_float(v.z));
  s[3] = __fadd_rn(s[3], __uint_as_float(v.w));
}

// out[blockIdx.y, n] = sum of x[r, n] over the rows r of chunk blockIdx.y, for
// the strip of columns blockIdx.x; N a multiple of the 16-byte vector
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
colsum_kernel(const T* __restrict__ x, float* __restrict__ out, long long n_rows, int N,
              int rows_per_chunk) {
  constexpr int kN = kVec<T>, kCols = 32 * kN;
  __shared__ float red[kWarps][kN][33];  // [warp][element of a lane's vector][lane]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.x * kCols + lane * kN;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_chunk;
  const long long r1 = r0 + rows_per_chunk < n_rows ? r0 + rows_per_chunk : n_rows;
  float s[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) s[k] = 0.f;
  if (col < N) {
    const T* p = x + col;
    long long r = r0 + warp;
    for (; r + (kUnroll - 1) * kWarps < r1; r += kUnroll * kWarps) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = __ldg(reinterpret_cast<const uint4*>(p + (r + u * kWarps) * N));
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add16(v[u], p, s);
    }
    for (; r < r1; r += kWarps) add16(__ldg(reinterpret_cast<const uint4*>(p + r * N)), p, s);
  }
#pragma unroll
  for (int k = 0; k < kN; ++k) red[warp][k][lane] = s[k];
  __syncthreads();
  // thread t adds column t of the strip over the warps, in warp order
  const int t = threadIdx.x;
  if (t < kCols && blockIdx.x * kCols + t < N) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total = __fadd_rn(total, red[w][t % kN][t / kN]);
    out[static_cast<size_t>(blockIdx.y) * N + blockIdx.x * kCols + t] = total;
  }
}

template <typename T>
cudaError_t launch(const T* x, float* out, long long n_rows, int N, int chunks, int rows_per_chunk,
                   cudaStream_t s) {
  constexpr int kCols = 32 * kVec<T>;
  colsum_kernel<T><<<dim3((N + kCols - 1) / kCols, chunks), kWarps * 32, 0, s>>>(
      x, out, n_rows, N, rows_per_chunk);
  return cudaGetLastError();
}

}  // namespace

// out [N] fp32 = column sums of x [rows, N] (fp32 if is_f32, else bf16), rows >= 1,
// N % 8 == 0 (bf16) or N % 4 == 0 (fp32), x 16-byte aligned; the rows in
// `chunks` chunks of `rows_per_chunk` (a multiple of 8), partial: [chunks, N]
// fp32 scratch
extern "C" int vt_colsum(const void* x, int is_f32, void* partial, void* out, long long n_rows,
                         int N, int chunks, int rows_per_chunk, void* stream) {
  if (n_rows <= 0 || N <= 0 || chunks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N % (is_f32 ? 4 : 8) != 0 || rows_per_chunk % kWarps != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  const cudaError_t err =
      is_f32 ? launch(static_cast<const float*>(x), p, n_rows, N, chunks, rows_per_chunk, s)
             : launch(static_cast<const __nv_bfloat16*>(x), p, n_rows, N, chunks, rows_per_chunk, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the partial rows, as one chunk of an fp32 matrix: warp w adds rows w, w + 8, ...
  const int padded = (chunks + kWarps - 1) / kWarps * kWarps;
  return static_cast<int>(launch(static_cast<const float*>(p), static_cast<float*>(out), chunks, N,
                                 1, padded, s));
}
