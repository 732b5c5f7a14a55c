// Host stand-ins for the CUDA features reveal.cu and maxsim.cu use, for
// the g++ rehearsal (run.sh). Each block runs as blockDim host threads, one block
// after another; __syncthreads is a std::barrier of the block, and the warp
// intrinsics exchange values through a second barrier per warp, so a
// barrier that not every thread reaches hangs here as it would on the card.
#pragma once
#include <stdint.h>

#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __shared__
#define __align__(n)
#define __launch_bounds__(...)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct uint4 {
  unsigned x, y, z, w;
};
struct float4 {
  float x, y, z, w;
};
inline thread_local dim3 threadIdx, blockIdx;

struct __nv_bfloat16 {
  uint16_t b;
};
inline float __bfloat162float(__nv_bfloat16 x) {
  const uint32_t u = (uint32_t)x.b << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// Built with -ffp-contract=off: each product and sum is rounded on its own.
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
template <typename T>
inline T __ldg(const T* p) {  // the read-only path: a plain load here
  return *p;
}
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

using cudaError_t = int;
using cudaStream_t = void*;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
template <typename K>
int cudaFuncSetAttribute(K, int, int) {
  return 0;
}
inline int cudaGetLastError() { return 0; }

struct BlockSync {
  std::barrier<> block;
  std::unique_ptr<std::barrier<>> warp[32];
  unsigned wval[32][32];
  float fval[32][32];
  std::atomic<int> any{0};  // __syncthreads_or's vote
  explicit BlockSync(int threads) : block(threads) {
    for (auto& w : warp) w = std::make_unique<std::barrier<>>(32);
  }
};
inline BlockSync* g_sync = nullptr;
inline long long g_barriers = 0;  // __syncthreads per run, for the report

inline void __syncthreads() {
  if (threadIdx.x == 0) ++g_barriers;
  g_sync->block.arrive_and_wait();
}
inline int __syncthreads_or(int p) {
  __syncthreads();  // everyone has read the previous vote
  if (threadIdx.x == 0) g_sync->any.store(0);
  __syncthreads();
  if (p) g_sync->any.store(1);
  __syncthreads();
  return g_sync->any.load();
}
inline unsigned __ballot_sync(unsigned, bool p) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_sync->wval[w][l] = p;
  g_sync->warp[w]->arrive_and_wait();
  unsigned b = 0;
  for (int i = 0; i < 32; ++i) b |= g_sync->wval[w][i] << i;
  g_sync->warp[w]->arrive_and_wait();
  return b;
}
inline float __shfl_xor_sync(unsigned, float x, int off) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_sync->fval[w][l] = x;
  g_sync->warp[w]->arrive_and_wait();
  const float y = g_sync->fval[w][l ^ off];
  g_sync->warp[w]->arrive_and_wait();
  return y;
}

// Dynamic shared memory, refilled with garbage before every block.
alignas(16) inline unsigned char smem_host[256 * 1024];
inline size_t g_smem_max = 0;  // largest launch, for the report

template <typename K, typename... A>
void host_launch(K kernel, dim3 grid, int threads, size_t smem, void*,
                 A... args) {
  if (smem > sizeof(smem_host) || threads > 1024) std::abort();
  if (smem > g_smem_max) g_smem_max = smem;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::memset(smem_host, 0xCD, sizeof(smem_host));
      BlockSync sync(threads);
      g_sync = &sync;
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([=] {
          threadIdx.x = t;
          blockIdx.x = bx;
          blockIdx.y = by;
          kernel(args...);
        });
      for (auto& t : ts) t.join();
    }
}
