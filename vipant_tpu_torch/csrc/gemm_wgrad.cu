// gemm_wgrad: the weight grads of both fused sub-blocks,
//
//   Y [N1, N2] fp32 = A^T . B   summed over the M rows of A [M, N1], B [M, N2],
//
// both bf16 and stored row-contiguous, so the reduction runs along the
// strided dimension of both operands (M = B*T rows: 19,584 for the audio
// tower at batch 64, 4,928 for the caption decoder).
//
// Replaces: the weight-grad products inside the Pallas kernels
//   vipant_tpu/ops/fused_attn.py::_bwd_kernel (dWout, line 220; dWqkv, line 232),
//   vipant_tpu/ops/fused_mlp.py::_bwd_kernel (dWproj, line 79; dWfc, line 83).
// The TPU kernels summed the weight grads over a sequential grid, one item
// at a time. On Hopper the blocks run in parallel and nothing carries over,
// and the output is small (36 to 144 tiles of 128 x 128 for 132 SMs) while
// the reduction is long. So the rows are split as well:
//
//   wgrad_kernel         grid (N2 tiles, N1 tiles, S row chunks); a block sums
//                        its chunk of rows into one fp32 128 x 128 tile and
//                        writes it to partial[chunk] (to Y itself when S = 1);
//   wgrad_reduce_kernel  Y = partial[0] + partial[1] + ... in that order.
//
// No atomics: the result is bitwise the same in every run. S and the chunk
// length come from the wrapper (`wgrad_split` in ops/kernels.py), a function
// of the shapes only. The partials cost S * N1 * N2 * 4 bytes written and
// read once more. At M = 19,584: dWout (768 x 768, S = 7) 33 MB, 10 us at
// the memory rate beside the product's 23 us bound, though they mostly stay
// in the 50 MB L2; dWqkv (S = 2) 28 MB, 8 us beside 70; dWproj and dWfc
// (S = 3) 57 MB, 17 us beside 93. A cluster reducing through distributed
// shared memory would save that round trip only where S <= 4 chunks of a
// tile run at once; it is not done here.
//
// Bound: tensor-core operations (2 * M * N1 * N2 against 989 TFLOP/s). The
// design is Hopper's: `wgmma.mma_async` m64n128k16, bf16 in, fp32
// accumulators in registers, both operands read from shared memory by
// descriptor. Both operands are MN-major here (64 consecutive columns of a
// row are the contiguous 128 bytes, the reduction index is the strided one),
// which bf16 `wgmma` takes through its transpose bits with the 128-byte
// swizzle: nothing is transposed in device memory or on the way in.
//
// Shared memory is a ring of kStages stages, each [64 rows of M] x [128
// columns] of A and of B (32 KB), filled by TMA (`cp.async.bulk.tensor`
// from tensor maps encoded on the host for this call, completion counted on
// an mbarrier) from one producer thread; two consumer warpgroups own 64 x 128
// of the tile each and keep one group of four `wgmma` in flight while they
// release the stage before it. TMA rather than cp.async: it writes the
// 128-byte swizzle the descriptors name, spends no registers or instruction slots
// of the consumers, and zero-fills whatever a box holds past M, N1 or N2, so
// ragged shapes need no code in the loop (columns past N1, N2 are masked on
// store). `cuTensorMapEncodeTiled` lives in libcuda, not in the runtime: it is looked up
// through the runtime (`cudaGetDriverEntryPoint`), so nothing is linked.
// Two blocks fit on an SM (3 stages = 96 KB each), so one block's store
// overlaps the other's products.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128;  // output tile: columns of A x columns of B
constexpr int BK = 64;             // rows of the reduction per stage
constexpr int kStages = 3;
constexpr int kBoxCols = 64;                    // 64 bf16 = the 128-byte swizzle span
constexpr int kBoxBytes = BK * kBoxCols * 2;    // one TMA box: 64 rows x 128 bytes
constexpr int kStageBytes = 4 * kBoxBytes;      // A: 2 boxes, B: 2 boxes
constexpr int kConsumerWarps = 8;               // two warpgroups, 64 x 128 of the tile each
constexpr int kThreads = kConsumerWarps * 32 + 32;  // and one producer warp
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;  // 1024: alignment

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// spins until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (done == 0);
}

// one 64-row x 64-column box at (column c0, row c1) of the tensor -> dst,
// its bytes counted on `bar`; what lies outside the tensor arrives as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor of an MN-major operand under the 128-byte
// swizzle. In 16-byte units the canonical layout is ((8, n), (8, k)) :
// ((1, LBO), (8, SBO)): 64 consecutive MN elements are one 128-byte row, 8
// reduction rows (1,024 bytes) are one swizzle atom; SBO strides from one
// atom of 8 reduction rows to the next (1,024 bytes in a box of 128-byte
// rows), LBO from one span of 64 MN elements to the next (the next box).
__device__ __forceinline__ uint64_t mn_major_desc(uint32_t addr, uint32_t lbo_bytes) {
  constexpr uint64_t kSbo = 1024 >> 4, kSwizzle128 = 1;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (kSbo << 32) | (kSwizzle128 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// d[64 x 128] += A[64 x 16] . B[16 x 128], both operands MN-major in shared
// memory (the two trailing 1s are the transpose bits of A and B)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"  // scale-d: accumulate onto d
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,  %1,  %2,  %3,  %4,  %5,  %6,  %7,  "
      " %8,  %9,  %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__global__ void __launch_bounds__(kThreads, 2)
wgrad_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
             float* __restrict__ out, int N1, int N2, int M, int rows_per_chunk) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t tiles = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle wants 1,024-byte boxes
  const uint32_t full = tiles + kStages * kStageBytes;           // one mbarrier per stage: filled
  const uint32_t empty = full + kStages * 8;                     // one per stage: read by all consumers

  const int n2_0 = blockIdx.x * BN, n1_0 = blockIdx.y * BM;
  const int row0 = blockIdx.z * rows_per_chunk;
  const int rows = min(M - row0, rows_per_chunk);
  const int nsteps = (rows + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: one thread keeps the ring full; the first pass over the
    // ring finds every stage empty (parity 1 passes on a fresh barrier)
    if (lane == 0) {
      for (int it = 0; it < nsteps; ++it) {
        const int s = it % kStages;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, kStageBytes);
        const uint32_t dst = tiles + s * kStageBytes;
        const int row = row0 + it * BK;
        tma_load(dst, &map_a, full + 8 * s, n1_0, row);
        tma_load(dst + kBoxBytes, &map_a, full + 8 * s, n1_0 + kBoxCols, row);
        tma_load(dst + 2 * kBoxBytes, &map_b, full + 8 * s, n2_0, row);
        tma_load(dst + 3 * kBoxBytes, &map_b, full + 8 * s, n2_0 + kBoxCols, row);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns tile rows [64 wg, 64 wg + 64), the columns
  // of A's box wg, against all 128 columns of B (two boxes, LBO apart)
  const int wg = warp >> 2;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int it = 0; it < nsteps; ++it) {
    const int s = it % kStages;
    mbar_wait(full + 8 * s, (it / kStages) & 1);
    const uint32_t stage = tiles + s * kStageBytes;
    const uint64_t desc_a = mn_major_desc(stage + wg * kBoxBytes, kBoxBytes);
    const uint64_t desc_b = mn_major_desc(stage + 2 * kBoxBytes, kBoxBytes);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) {
      // 16 reduction rows further on: 16 x 128 bytes, in the descriptor's 16-byte units
      const uint64_t step = static_cast<uint64_t>(k * 16 * 128) >> 4;
      wgmma_m64n128k16(acc, desc_a + step, desc_b + step);
    }
    wgmma_commit();
    if (it > 0) {
      wgmma_wait<1>();  // the group before this one has read its stage
      if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
    }
  }
  wgmma_wait<0>();

  // accumulator i of lane l in warp w of the warpgroup: row 16 w + l / 4 (+ 8
  // for i % 4 >= 2), column 8 (i / 4) + 2 (l % 4) + i % 2
  out += static_cast<size_t>(blockIdx.z) * N1 * N2;
  const int r = n1_0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int c = n2_0 + (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = c + j * 8;
    if (col < N2) {  // N2 is a multiple of 8: the pair is in or out together
      if (r < N1)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * N2 + col) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (r + 8 < N1)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(r + 8) * N2 + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// y = partial[0] + partial[1] + ... + partial[S - 1], in that order
__global__ void wgrad_reduce_kernel(const float4* __restrict__ partial, float4* __restrict__ y,
                                    int n4, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 acc = partial[i];
  for (int s = 1; s < S; ++s) {
    const float4 v = partial[static_cast<size_t>(s) * n4 + i];
    acc.x = __fadd_rn(acc.x, v.x);
    acc.y = __fadd_rn(acc.y, v.y);
    acc.z = __fadd_rn(acc.z, v.z);
    acc.w = __fadd_rn(acc.w, v.w);
  }
  y[i] = acc;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// the tensor map of a row-contiguous [M, N] bf16 matrix, cut into boxes of
// 64 rows x 64 columns under the 128-byte swizzle; outside the matrix: zeros
bool make_map(CUtensorMap* map, const void* base, int M, int N) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * 2};
  const cuuint32_t box[2] = {kBoxCols, BK};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// y [N1, N2] fp32 = a^T . b summed over the M rows of a [M, N1], b [M, N2]
// (N1, N2 multiples of 8), the rows cut into S chunks of rows_per_chunk (a
// multiple of 64; the last may be short). partial: [S, N1, N2] fp32 scratch,
// unused (may be null) when S = 1.
extern "C" int vt_gemm_wgrad(const void* a, const void* b, void* y, void* partial, int N1, int N2,
                             int M, int S, int rows_per_chunk, void* stream) {
  if (N1 <= 0 || N2 <= 0) return 0;
  if (M <= 0 || S < 1 || rows_per_chunk % BK != 0 || N1 % 8 != 0 || N2 % 8 != 0 ||
      static_cast<long long>(S - 1) * rows_per_chunk >= M ||
      static_cast<long long>(S) * rows_per_chunk < M || (S > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, a, M, N1) || !make_map(&map_b, b, M, N2))
    return static_cast<int>(cudaErrorNotSupported);
  cudaError_t err = cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N2 + BN - 1) / BN, (N1 + BM - 1) / BM, S);
  wgrad_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      map_a, map_b, static_cast<float*>(S == 1 ? y : partial), N1, N2, M, rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  const int n4 = N1 * N2 / 4;
  wgrad_reduce_kernel<<<(n4 + 255) / 256, 256, 0, s>>>(static_cast<const float4*>(partial),
                                                       static_cast<float4*>(y), n4, S);
  return static_cast<int>(cudaGetLastError());
}
