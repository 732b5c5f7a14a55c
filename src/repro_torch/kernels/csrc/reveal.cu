// Gathered MaxSim reveal for the pooled Col-Bandit frontier (sm_90a).
//
// One body, two entry points:
//   colbandit_fused_reveal   replaces src/repro/kernels/reveal.py
//                            fused_reveal / _fused_reveal_kernel
//   colbandit_gather_maxsim  replaces src/repro/kernels/gather_maxsim.py
//                            gather_maxsim / _gather_maxsim_kernel
//
// vals[f, g] = max_{l valid} <E[doc_idx[f], l], Q[tok_idx[f, g]]>, -3e38 for
// an all-masked doc; the fused entry also writes stats[f] =
// [sum new, sum new*v, sum (new?v:0)*v] over new_mask[f].
//
// Bound: bytes. A frontier row reads its doc's valid (L, M) tokens once and
// does 2*G*M flops per token, G/2 flop per f32 byte: below the ~20
// flop/byte ridge of the f32 CUDA cores for G < 40 (the serving path runs
// G = 1 for the init reveal and G = 8 per round). Design: one block per
// frontier row reads its own doc_idx[f] (the TPU kernel's scalar prefetch) and gathers its G query rows
// into shared memory, so no (F, L, M) gathered copy ever reaches device
// memory. Each warp streams whole doc tokens, coalesced, through a private
// shared-memory row; lanes split M and a xor-shuffle tree finishes the dot,
// so one cell's value never depends on its frontier row, its g slot or G.
// The two entry points share that code, hence the chain and fused round
// bodies see bit-identical values. Thread 0 sums the stats serially in
// ascending g with no FMA contraction: the plain PyTorch version
// (kernels/reveal.py::reveal_stats) repeats that order exactly.
// Out-of-range indices are clamped, as an XLA gather does.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename TE, typename TQ, bool kStats>
__global__ void __launch_bounds__(kThreads)
reveal_kernel(const TE* __restrict__ E, const uint8_t* __restrict__ mask,
              const TQ* __restrict__ Qt, const int64_t* __restrict__ doc_idx,
              const int64_t* __restrict__ tok_idx,
              const uint8_t* __restrict__ new_mask, float* __restrict__ vals,
              float* __restrict__ stats, int G, int L, int M, int64_t D,
              int64_t TQn) {
  extern __shared__ float smem[];
  float* q_s = smem;                        // (G, M) selected query rows
  float* e_s = q_s + (size_t)G * M;         // (kWarps, M) one doc row per warp
  float* w_max = e_s + (size_t)kWarps * M;  // (kWarps, G) running max per warp
  float* v_s = w_max + kWarps * G;          // (G,) finished values

  const int64_t f = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int64_t d = doc_idx[f];
  d = d < 0 ? 0 : (d >= D ? D - 1 : d);

  for (int i = tid; i < G * M; i += kThreads) {
    const int g = i / M, m = i - g * M;
    int64_t t = tok_idx[f * G + g];
    t = t < 0 ? 0 : (t >= TQn ? TQn - 1 : t);
    q_s[i] = to_f32(Qt[t * M + m]);
  }
  for (int i = tid; i < kWarps * G; i += kThreads) w_max[i] = COLBANDIT_NEG;
  __syncthreads();

  const TE* e_doc = E + d * (int64_t)L * M;
  const uint8_t* m_doc = mask + d * (int64_t)L;
  float* e_w = e_s + warp * M;
  float* w_row = w_max + warp * G;
  for (int l = warp; l < L; l += kWarps) {
    if (!m_doc[l]) continue;  // warp-uniform: masked tokens are never read
    const TE* e_l = e_doc + (int64_t)l * M;
    for (int m = lane; m < M; m += 32) e_w[m] = to_f32(e_l[m]);
    __syncwarp();
    for (int g = 0; g < G; ++g) {
      const float* q_g = q_s + g * M;
      float acc = 0.f;
      for (int m = lane; m < M; m += 32) acc = fmaf(e_w[m], q_g[m], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) w_row[g] = nan_max(w_row[g], acc);
    }
    __syncwarp();
  }
  __syncthreads();

  for (int g = tid; g < G; g += kThreads) {
    float v = COLBANDIT_NEG;
    for (int w = 0; w < kWarps; ++w) v = nan_max(v, w_max[w * G + g]);
    vals[f * G + g] = v;
    v_s[g] = v;
  }
  if (kStats) {
    __syncthreads();
    if (tid == 0) {
      float cnt = 0.f, tot = 0.f, sq = 0.f;
      for (int g = 0; g < G; ++g) {
        const bool fresh = new_mask[f * G + g] != 0;
        const float v = v_s[g];
        // vm * v, not new * v * v: an all-masked doc's -3e38 squared would
        // overflow to inf and 0 * inf is NaN.
        const float vm = fresh ? v : 0.f;
        cnt = __fadd_rn(cnt, fresh ? 1.f : 0.f);
        tot = __fadd_rn(tot, vm);
        sq = __fadd_rn(sq, __fmul_rn(vm, v));
      }
      stats[f * 3 + 0] = cnt;
      stats[f * 3 + 1] = tot;
      stats[f * 3 + 2] = sq;
    }
  }
}

template <typename TE, typename TQ, bool kStats>
int launch(const void* E, const uint8_t* mask, const void* Q,
           const int64_t* doc_idx, const int64_t* tok_idx,
           const uint8_t* new_mask, float* vals, float* stats, int F, int G,
           int L, int M, long long D, long long n_tok, cudaStream_t stream) {
  const size_t smem =
      ((size_t)G * M + (size_t)kWarps * M + (size_t)kWarps * G + G) *
      sizeof(float);
  auto kernel = reveal_kernel<TE, TQ, kStats>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<F, kThreads, smem, stream>>>(
      static_cast<const TE*>(E), mask, static_cast<const TQ*>(Q), doc_idx,
      tok_idx, new_mask, vals, stats, G, L, M, D, n_tok);
  return (int)cudaGetLastError();
}

template <bool kStats>
int dispatch(const void* E, const uint8_t* mask, const void* Q,
             const int64_t* doc_idx, const int64_t* tok_idx,
             const uint8_t* new_mask, float* vals, float* stats, int F, int G,
             int L, int M, long long D, long long n_tok, int e_bf16, int q_bf16,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e_bf16 && q_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16, kStats>(
        E, mask, Q, doc_idx, tok_idx, new_mask, vals, stats, F, G, L, M, D,
        n_tok, s);
  if (e_bf16)
    return launch<__nv_bfloat16, float, kStats>(
        E, mask, Q, doc_idx, tok_idx, new_mask, vals, stats, F, G, L, M, D,
        n_tok, s);
  if (q_bf16)
    return launch<float, __nv_bfloat16, kStats>(
        E, mask, Q, doc_idx, tok_idx, new_mask, vals, stats, F, G, L, M, D,
        n_tok, s);
  return launch<float, float, kStats>(E, mask, Q, doc_idx, tok_idx, new_mask,
                                      vals, stats, F, G, L, M, D, n_tok, s);
}

}  // namespace

extern "C" int colbandit_fused_reveal(const void* E, const uint8_t* mask,
                                      const void* Q, const int64_t* doc_idx,
                                      const int64_t* tok_idx,
                                      const uint8_t* new_mask, float* vals,
                                      float* stats, int F, int G, int L, int M,
                                      long long D, long long n_tok, int e_bf16,
                                      int q_bf16, void* stream) {
  return dispatch<true>(E, mask, Q, doc_idx, tok_idx, new_mask, vals, stats,
                        F, G, L, M, D, n_tok, e_bf16, q_bf16, stream);
}

extern "C" int colbandit_gather_maxsim(const void* E, const uint8_t* mask,
                                       const void* Q, const int64_t* doc_idx,
                                       const int64_t* tok_idx, float* vals,
                                       int F, int G, int L, int M, long long D,
                                       long long n_tok, int e_bf16, int q_bf16,
                                       void* stream) {
  return dispatch<false>(E, mask, Q, doc_idx, tok_idx, nullptr, vals, nullptr,
                         F, G, L, M, D, n_tok, e_bf16, q_bf16, stream);
}
