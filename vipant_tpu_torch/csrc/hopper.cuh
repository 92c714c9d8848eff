// Hopper building blocks shared by the TMA + `wgmma` kernels (gemm_fwd.cu,
// gemm_dgrad.cu, gemm_wgrad.cu, gemm_i8.cu, dot_variants.cu): mbarriers, TMA loads from
// tensor maps encoded on the host per call, shared-memory matrix
// descriptors under the 128-byte swizzle and `wgmma.mma_async` m64n128k16
// and m64n64k16 (bf16 in, fp32 accumulators in registers) and m64n128k32
// (int8 in, int32 accumulators).
//
// `cuTensorMapEncodeTiled` lives in libcuda, not in the runtime: it is looked
// up through the runtime (`cudaGetDriverEntryPoint`), so nothing is linked.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA); one
// thread, after its mbar_init calls and before the block's first barrier
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// one box at (inner coordinate c0, outer coordinate c1) of the tensor ->
// dst, its bytes counted on `bar`; what lies outside the tensor arrives as
// zeros (and is counted all the same)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor of an operand staged by TMA under the
// 128-byte swizzle: rows of 128 bytes (64 bf16 or 128 int8 codes), 8 rows
// (1,024 bytes) to a swizzle atom, SBO = 1,024 bytes from one atom to the
// next. `lbo_bytes`: for an MN-major operand, the stride from one span of 64
// MN elements to the next; a K-major operand whose k step (16 bf16 or 32
// codes: 32 bytes) lies inside the 128-byte row does not use it (16 by
// convention). The swizzle is a function of the address bits, so the atoms
// must be 1,024-byte aligned and a k step inside a row is taken by adding
// its byte offset to the address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes) {
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

// keeps the compiler from moving reads or writes of the accumulators across
// this point (around the asynchronous products that own them)
template <int kN>
__device__ __forceinline__ void fence_acc(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int kN>
__device__ __forceinline__ void fence_acc(int (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] . B[16 x 128], both operands in shared memory
// by descriptor; kTransA / kTransB = 1: that operand MN-major (its transpose
// bit), 0: K-major. Accumulator i of lane l in warp w of the warpgroup: row
// 16 w + l / 4 (+ 8 for i % 4 >= 2), column 8 (i / 4) + 2 (l % 4) + i % 2.
template <int kTransA, int kTransB>
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
      "%64, %65, p, 1, 1, %67, %68;\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransA), "n"(kTransB));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64]: wgmma_m64n128k16 at half the
// width (dot_variants.cu), the transpose bits as there. Accumulator i of lane
// l in warp w of the warpgroup: row 16 w + l / 4 (+ 8 for i % 4 >= 2), column
// 8 (i / 4) + 2 (l % 4) + i % 2, as in the n128 form with i < 32.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"  // scale-d: accumulate onto d
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,  %1,  %2,  %3,  %4,  %5,  %6,  %7,  "
      " %8,  %9,  %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransA), "n"(kTransB));
}

// d[64 x 128] += A[64 x 32] . B[32 x 128], int8 codes in, exact int32
// accumulators; both operands K-major, the only form 8-bit `wgmma` takes
// (it has no transpose bits). The accumulators are laid out as
// wgmma_m64n128k16's.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"  // scale-d: accumulate onto d
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0,  %1,  %2,  %3,  %4,  %5,  %6,  %7,  "
      " %8,  %9,  %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The SM count of the current device, kept in `sms` (one table per calling
// file); on a device's first call the dynamic shared-memory limit of each of
// `kernels` is raised to `smem` bytes. -1 if a query or the raise fails.
template <class... Kernels>
inline int prepare_device(int (&sms)[64], int smem, Kernels... kernels) {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  if (sms[dev] == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        !((cudaFuncSetAttribute(kernels, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) == cudaSuccess) &&
          ...))
      return -1;
    sms[dev] = n;
  }
  return sms[dev];
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
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

// the tensor map of a row-contiguous [rows, cols] matrix of bf16 or (type
// UINT8) int8 codes (rows of a multiple of 16 bytes: TMA's stride rule),
// cut into boxes of box_rows rows x 128 bytes (64 bf16, 128 codes) under the
// 128-byte swizzle; outside the matrix: zeros
inline bool make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
                     CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int elem_bytes = type == CU_TENSOR_MAP_DATA_TYPE_UINT8 ? 1 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
