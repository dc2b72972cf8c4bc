// Asynchronous copies from device memory into shared memory (cp.async,
// sm_80 and up): knn_exact.cu stages candidate chunks, segment_sum.cu
// the long runs' spans.  A copy is 16 bytes, both addresses 16-byte
// aligned; a thread's copies since its last commit form one group, and
// wait<N> returns once at most N of its groups are still in flight.
#pragma once

#include <cuda_runtime.h>

namespace cp_async {

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

}  // namespace cp_async
