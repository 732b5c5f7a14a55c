// Synchronous stand-in for csrc/async_copy.cuh in the host rehearsal
// (run.sh): a copy lands at once, so commit and wait do nothing. It checks
// the alignment cp.async requires and counts the copies by size.
#pragma once
#include <stdint.h>

#include <cstdlib>
#include <cstring>

inline long long g_async_copies[17];

template <int kBytes>
inline void copy_async(void* smem, const void* gmem) {
  static_assert(kBytes == 4 || kBytes == 8 || kBytes == 16,
                "cp.async copies 4, 8 or 16 bytes");
  if (reinterpret_cast<uintptr_t>(smem) % kBytes ||
      reinterpret_cast<uintptr_t>(gmem) % kBytes)
    std::abort();
  std::memcpy(smem, gmem, kBytes);
  __atomic_fetch_add(&g_async_copies[kBytes], 1, __ATOMIC_RELAXED);
}
inline void copy_async_commit() {}
template <int kPending>
inline void copy_async_wait() {}
