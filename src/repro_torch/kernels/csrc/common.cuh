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

// Row loaders: how a kernel body reads element m of corpus token row r
// (r = doc * L + l). A body is templated on its loader, so one body serves
// every corpus kind. Bodies copy rows raw (cp.async): `raw(r)` is the row's
// M stored elements of type `Elem`, with `scale(r)` and `code(r)` beside it
// (`kScaled`), and `at` turns a stored element into its value. `kCodebook`
// says whether rows add a codebook row (staged in shared memory where the
// layout has room for it, else read from global memory).
//
// DenseRows: a float32 or bf16 corpus (D, L, M).
template <typename TE>
struct DenseRows {
  using Elem = TE;
  static constexpr bool kCodebook = false;
  static constexpr bool kScaled = false;
  const TE* E;
  int M;
  static __device__ __forceinline__ float at(TE x, float, const float*,
                                             int) {
    return to_f32(x);
  }
  __host__ __device__ __forceinline__ const TE* raw(int64_t r) const {
    return E + r * M;
  }
  __device__ __forceinline__ float scale(int64_t) const { return 1.f; }
  __device__ __forceinline__ int code(int64_t) const { return 0; }
};

// QuantRows: an int8 corpus, data (D, L, M) int8 and scales (D, L) of TS
// (bf16 or f32); with kResidual also codes (D, L) int32 and a (Kc, M) f32
// codebook. Element m of row r is data * scale, plus codebook[code][m] for
// the residual format, each step rounded on its own (__fmul_rn,
// __fadd_rn: no FMA contraction), as kernels/quant.py::dequant_block does
// in PyTorch. A dequantized element is therefore bit-equal to the plain
// version's, and a body on QuantRows equals the same body on DenseRows
// over the dequantized corpus bit for bit. Codes outside [0, Kc) are
// clamped, as an index into the codebook must stay in bounds.
template <typename TS, bool kResidual>
struct QuantRows {
  using Elem = int8_t;
  static constexpr bool kCodebook = kResidual;
  static constexpr bool kScaled = true;
  const int8_t* data;
  const TS* scales;
  const int32_t* codes;
  const float* codebook;  // global (Kc, M); staged in cb_s where it fits
  int M, Kc;
  // Element m of a row with scale s; c is the row's centroid (residual).
  static __device__ __forceinline__ float at(int8_t x, float s,
                                             const float* c, int m) {
    const float v = __fmul_rn(static_cast<float>(x), s);
    if constexpr (kResidual) {
      return __fadd_rn(v, c[m]);
    } else {
      return v;
    }
  }
  __host__ __device__ __forceinline__ const int8_t* raw(int64_t r) const {
    return data + r * M;
  }
  __device__ __forceinline__ float scale(int64_t r) const {
    return to_f32(scales[r]);
  }
  __device__ __forceinline__ int code(int64_t r) const {
    if constexpr (kResidual) {
      const int k = codes[r];
      return k < 0 ? 0 : (k >= Kc ? Kc - 1 : k);
    } else {
      return 0;
    }
  }
};

// Shared memory one block may take on the H100 (227 KB; _build.py's
// SHARED_MEM_BYTES). A body's layout stages its residual codebook only where
// the whole layout stays within it, and reads the codebook from global
// memory (the read-only path) above that.
constexpr size_t kSharedMemBytes = 227 * 1024;

// Opt in to more than 48 KB of dynamic shared memory where needed.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
