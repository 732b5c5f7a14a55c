// Asynchronous global -> shared memory copies (cp.async, sm_80 and later).
//
// Kept in a header of their own so the only inline PTX of a body sits in
// three small functions: a host rehearsal of the kernels (verify skill)
// swaps in a header of the same name whose copies are synchronous.
#pragma once

// Start a copy of kBytes (4, 8 or 16) bytes; both addresses are aligned to
// kBytes. 16-byte copies bypass L1 (.cg): a staged row is read once.
template <int kBytes>
__device__ __forceinline__ void copy_async(void* smem, const void* gmem) {
  static_assert(kBytes == 4 || kBytes == 8 || kBytes == 16,
                "cp.async copies 4, 8 or 16 bytes");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(kBytes)
                 : "memory");
  }
}

// Close the copies this thread started since the last commit into a group.
__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's groups are still in flight.
template <int kPending>
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
