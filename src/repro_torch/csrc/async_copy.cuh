// Asynchronous global -> shared copies (cp.async, sm_80 and later), shared
// by `spikemm.cu`, `stdp.cu` and `rec_scan.cuh`. A thread's copies are
// grouped by `cp_async_commit`; `cp_async_wait<N>` returns once at most N
// of its groups are still in flight. Other threads see the data only after
// a barrier (__syncwarp or __syncthreads) that both sides pass.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared copies that complete asynchronously; `in` false writes
// zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
