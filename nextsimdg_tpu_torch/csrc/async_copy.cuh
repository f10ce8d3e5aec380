// Asynchronous copies from global into shared memory (cp.async), for the
// window loads of transport_tiled.cu: each thread starts copies of 4 or 16
// bytes, which write zeros instead where the source size is 0, commits
// them as a group, and later waits until no more than a given number of
// its groups are still in flight. The copies run while the thread goes on
// computing; a block barrier after the wait makes every thread's copies
// visible to the block.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace nst {

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// kVec floats from `src` into `dst`, or kVec zeros where !valid (src is
// then not read, but must be a valid address). kVec 4 needs both 16-byte
// aligned.
template <int kVec>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  static_assert(kVec == 1 || kVec == 4, "cp.async copies 4 or 16 bytes here");
  if (kVec == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(shared_address(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(shared_address(dst)),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most `kPending` of this thread's committed groups are
// still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

}  // namespace nst
