// Shared device helpers for the Col-Bandit MaxSim kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The all-masked-document sentinel of the JAX package (kernels/*.py _NEG).
#define COLBANDIT_NEG (-3e38f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Max that lets a NaN operand win, as jnp.maximum and torch.maximum do:
// the frontier's finite-score quarantine has to see a poisoned cell.
__device__ __forceinline__ float nan_max(float acc, float x) {
  return (x > acc || x != x) ? x : acc;
}

// Opt in to more than 48 KB of dynamic shared memory where needed.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
