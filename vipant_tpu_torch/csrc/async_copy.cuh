// cp.async helpers shared by attention.cu and attention_bwd.cu:
// 16- and 4-byte asynchronous copies from device to shared memory,
// committed in groups.

#pragma once

#include <cuda_runtime.h>

namespace async_copy {

// 16 bytes to shared memory; with `pred` false nothing is read and 16 zero
// bytes are written (src-size 0), so `gmem` only has to be a valid address
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// 4 bytes, the same way (cp.async.ca: the 16-byte .cg form takes no other size)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most kPending of this thread's committed groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

}  // namespace async_copy
