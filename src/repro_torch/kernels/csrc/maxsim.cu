// Dense batched MaxSim for the dense rerank flavor and the exhaustive oracle
// (sm_90a). Replaces src/repro/kernels/maxsim.py maxsim / _maxsim_kernel,
// which ops.maxsim_batch_op vmaps over the query batch.
//
// H[b, i, t] = max_{l valid} <E[b, i, l], Q[b, t]>, -3e38 for an
// all-masked doc. E (B, N, L, M), mask (B, N, L), Q (B, T, M) -> H (B, N, T).
//
// Bound: at the serving shape (T = 32, M = 128) each doc token is read once
// (4*M bytes) and used for 2*T*M flops, 16 flop per byte, just under the
// ~20 flop/byte ridge of the f32 CUDA cores: bytes and f32 issue rate
// bound it about equally. Design: one block per (query b, doc i), with the
// batch a grid axis, so the (B, N, L, T) similarity tensor never exists.
// The block keeps a 32-token slice of its query transposed in shared
// memory, streams the doc through a 32-token shared tile (tiles with no
// valid token are skipped, so a short doc's padding is never read), and
// each thread keeps 4 doc rows x 1 query token in registers: 5 shared loads
// per 4 FMAs, conflict-free (the doc rows are warp-wide broadcasts, the
// query column is lane-contiguous). A running max per query token lives in
// a register; the 8 warps' maxima meet in shared memory at the end. Each
// dot is a sequential FMA chain over M, so a cell's value is independent
// of the launch shape.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                 // doc rows per thread
constexpr int kTileL = kWarps * kRows;   // doc tokens per shared tile
constexpr int kColT = 32;                // query tokens per pass, one per lane

template <typename TE, typename TQ>
__global__ void __launch_bounds__(kThreads)
maxsim_kernel(const TE* __restrict__ E, const uint8_t* __restrict__ mask,
              const TQ* __restrict__ Qb, float* __restrict__ H, int N, int L,
              int M, int T) {
  extern __shared__ float smem[];
  float* q_s = smem;                        // (M, kColT) query slice, transposed
  float* e_s = q_s + (size_t)M * kColT;     // (kTileL, M) doc token tile
  float* red = e_s + (size_t)kTileL * M;    // (kWarps, kColT) per-warp maxima

  const int64_t doc = (int64_t)blockIdx.y * N + blockIdx.x;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const TE* e_doc = E + doc * L * M;
  const uint8_t* m_doc = mask + doc * L;
  const TQ* q_b = Qb + (int64_t)blockIdx.y * T * M;
  float* h_doc = H + doc * T;

  for (int t0 = 0; t0 < T; t0 += kColT) {
    const int tc = min(kColT, T - t0);
    __syncthreads();  // the previous pass is done with q_s and red
    for (int i = tid; i < kColT * M; i += kThreads) {
      const int t = i / M, m = i - t * M;
      q_s[m * kColT + t] =
          t < tc ? to_f32(q_b[(int64_t)(t0 + t) * M + m]) : 0.f;
    }
    float run = COLBANDIT_NEG;
    for (int l0 = 0; l0 < L; l0 += kTileL) {
      const int lc = min(kTileL, L - l0);
      // Also the barrier after which q_s is written and e_s is free.
      if (!__syncthreads_or(tid < lc && m_doc[l0 + tid])) continue;
      for (int i = tid; i < kTileL * M; i += kThreads) {
        e_s[i] = i / M < lc ? to_f32(e_doc[(int64_t)l0 * M + i]) : 0.f;
      }
      __syncthreads();
      float acc[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
      const float* e_r = e_s + (size_t)ty * kRows * M;
      for (int m = 0; m < M; ++m) {
        const float q = q_s[m * kColT + tx];
#pragma unroll
        for (int j = 0; j < kRows; ++j) acc[j] = fmaf(e_r[j * M + m], q, acc[j]);
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int r = ty * kRows + j;
        if (r < lc && m_doc[l0 + r]) run = nan_max(run, acc[j]);
      }
    }
    red[ty * kColT + tx] = run;
    __syncthreads();
    if (tid < tc) {
      float v = COLBANDIT_NEG;
      for (int w = 0; w < kWarps; ++w) v = nan_max(v, red[w * kColT + tid]);
      h_doc[t0 + tid] = v;
    }
  }
}

template <typename TE, typename TQ>
int launch(const void* E, const uint8_t* mask, const void* Q, float* H, int B,
           int N, int L, int M, int T, cudaStream_t stream) {
  const size_t smem =
      ((size_t)M * kColT + (size_t)kTileL * M + kWarps * kColT) *
      sizeof(float);
  auto kernel = maxsim_kernel<TE, TQ>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(N, B), kThreads, smem, stream>>>(
      static_cast<const TE*>(E), mask, static_cast<const TQ*>(Q), H, N, L, M,
      T);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int colbandit_maxsim(const void* E, const uint8_t* mask,
                                const void* Q, float* H, int B, int N, int L,
                                int M, int T, int e_bf16, int q_bf16,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e_bf16 && q_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(E, mask, Q, H, B, N, L, M, T,
                                                s);
  if (e_bf16)
    return launch<__nv_bfloat16, float>(E, mask, Q, H, B, N, L, M, T, s);
  if (q_bf16)
    return launch<float, __nv_bfloat16>(E, mask, Q, H, B, N, L, M, T, s);
  return launch<float, float>(E, mask, Q, H, B, N, L, M, T, s);
}
