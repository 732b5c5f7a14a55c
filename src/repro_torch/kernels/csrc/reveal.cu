// Gathered MaxSim reveal for the pooled Col-Bandit frontier (sm_90a).
//
// One body, four entry points:
//   colbandit_fused_reveal     replaces src/repro/kernels/reveal.py
//                              fused_reveal / _fused_reveal_kernel
//   colbandit_gather_maxsim    replaces src/repro/kernels/gather_maxsim.py
//                              gather_maxsim / _gather_maxsim_kernel
//   colbandit_fused_reveal_q   replaces src/repro/kernels/reveal.py
//                              fused_reveal / _fused_reveal_q_kernel
//   colbandit_gather_maxsim_q  replaces src/repro/kernels/gather_maxsim.py
//                              gather_maxsim / _gather_maxsim_q_kernel
// The _q entry points read a compressed corpus (int8 rows with a per-row
// scale, optionally a centroid id into a shared codebook) through
// common.cuh's QuantRows loader; the others read float32/bf16 rows.
//
// vals[f, g] = max_{l valid} <E[doc_idx[f], l], Q[tok_idx[f, g]]>, -3e38 for
// an all-masked doc; the fused entries also write stats[f] =
// [sum new, sum new*v, sum (new?v:0)*v] over new_mask[f].
//
// Bound: bytes. A frontier row reads its doc's valid (L, M) tokens once and
// does 2*G*M flops per token: G/2 flop per f32 byte, 2*G per int8 byte,
// below the ~20 flop/byte ridge of the f32 CUDA cores for the serving
// path's G = 1 (init reveal) and G = 8 (rounds). Design: one block per
// frontier row reads its own doc_idx[f] (the TPU kernel's scalar prefetch)
// and gathers its G query rows into shared memory, so no (F, L, M) gathered
// copy ever reaches device memory. Each warp streams whole doc tokens,
// coalesced, through a private shared-memory row; on a compressed corpus the
// loader dequantizes the row on the way in (only int8 bytes, the row's
// scale and code leave device memory; the residual codebook is staged in
// shared memory once per block). Lanes split M and a xor-shuffle tree
// finishes the dot, so one cell's value never depends on its frontier row,
// its g slot or G. All entry points share that code, hence the chain and
// fused round bodies see bit-identical values on every corpus kind. Thread
// 0 sums the stats serially in ascending g with no FMA contraction: the
// plain PyTorch version (kernels/reveal.py::reveal_stats) repeats that order
// exactly. Out-of-range indices are clamped, as an XLA gather does.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename Rows, typename TQ, bool kStats>
__global__ void __launch_bounds__(kThreads)
reveal_kernel(Rows rows, const uint8_t* __restrict__ mask,
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
  float* cb_s = v_s + G;                    // (Kc, M) codebook, residual only

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
  stage_codebook(rows, cb_s, tid, kThreads);
  __syncthreads();

  const uint8_t* m_doc = mask + d * (int64_t)L;
  float* e_w = e_s + warp * M;
  float* w_row = w_max + warp * G;
  for (int l = warp; l < L; l += kWarps) {
    if (!m_doc[l]) continue;  // warp-uniform: masked tokens are never read
    const auto e_l = rows.row(d * L + l, cb_s);
    for (int m = lane; m < M; m += 32) e_w[m] = e_l(m);
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

// Operands of one launch, whatever the corpus kind.
struct Args {
  const uint8_t* mask;
  const void* Q;
  const int64_t* doc_idx;
  const int64_t* tok_idx;
  const uint8_t* new_mask;
  float* vals;
  float* stats;
  int F, G, L, M;
  long long D, n_tok;
  cudaStream_t stream;
};

template <typename Rows, typename TQ, bool kStats>
int launch(const Rows& rows, const Args& a) {
  const size_t smem = ((size_t)a.G * a.M + (size_t)kWarps * a.M +
                       (size_t)kWarps * a.G + a.G + codebook_floats(rows)) *
                      sizeof(float);
  auto kernel = reveal_kernel<Rows, TQ, kStats>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.F, kThreads, smem, a.stream>>>(
      rows, a.mask, static_cast<const TQ*>(a.Q), a.doc_idx, a.tok_idx,
      a.new_mask, a.vals, a.stats, a.G, a.L, a.M, a.D, a.n_tok);
  return (int)cudaGetLastError();
}

template <typename Rows, bool kStats>
int by_query(const Rows& rows, const Args& a, int q_bf16) {
  if (q_bf16) return launch<Rows, __nv_bfloat16, kStats>(rows, a);
  return launch<Rows, float, kStats>(rows, a);
}

template <bool kStats>
int dense(const void* E, const Args& a, int e_bf16, int q_bf16) {
  if (e_bf16)
    return by_query<DenseRows<__nv_bfloat16>, kStats>(
        {static_cast<const __nv_bfloat16*>(E), a.M}, a, q_bf16);
  return by_query<DenseRows<float>, kStats>(
      {static_cast<const float*>(E), a.M}, a, q_bf16);
}

template <typename TS, bool kStats>
int quant_scales(const int8_t* data, const void* scales, const int32_t* codes,
                 const float* codebook, int Kc, const Args& a, int q_bf16) {
  const TS* s = static_cast<const TS*>(scales);
  if (codes != nullptr)
    return by_query<QuantRows<TS, true>, kStats>(
        {data, s, codes, codebook, a.M, Kc}, a, q_bf16);
  return by_query<QuantRows<TS, false>, kStats>(
      {data, s, nullptr, nullptr, a.M, 0}, a, q_bf16);
}

template <bool kStats>
int quant(const int8_t* data, const void* scales, const int32_t* codes,
          const float* codebook, int Kc, const Args& a, int s_bf16,
          int q_bf16) {
  if (s_bf16)
    return quant_scales<__nv_bfloat16, kStats>(data, scales, codes, codebook,
                                               Kc, a, q_bf16);
  return quant_scales<float, kStats>(data, scales, codes, codebook, Kc, a,
                                     q_bf16);
}

}  // namespace

extern "C" int colbandit_fused_reveal(const void* E, const uint8_t* mask,
                                      const void* Q, const int64_t* doc_idx,
                                      const int64_t* tok_idx,
                                      const uint8_t* new_mask, float* vals,
                                      float* stats, int F, int G, int L, int M,
                                      long long D, long long n_tok, int e_bf16,
                                      int q_bf16, void* stream) {
  const Args a{mask, Q, doc_idx, tok_idx, new_mask, vals, stats, F, G, L, M,
               D, n_tok, static_cast<cudaStream_t>(stream)};
  return dense<true>(E, a, e_bf16, q_bf16);
}

extern "C" int colbandit_gather_maxsim(const void* E, const uint8_t* mask,
                                       const void* Q, const int64_t* doc_idx,
                                       const int64_t* tok_idx, float* vals,
                                       int F, int G, int L, int M, long long D,
                                       long long n_tok, int e_bf16, int q_bf16,
                                       void* stream) {
  const Args a{mask, Q, doc_idx, tok_idx, nullptr, vals, nullptr, F, G, L, M,
               D, n_tok, static_cast<cudaStream_t>(stream)};
  return dense<false>(E, a, e_bf16, q_bf16);
}

// codes and codebook are nullptr for the int8 format (Kc ignored).
extern "C" int colbandit_fused_reveal_q(
    const int8_t* data, const void* scales, const int32_t* codes,
    const float* codebook, int Kc, const uint8_t* mask, const void* Q,
    const int64_t* doc_idx, const int64_t* tok_idx, const uint8_t* new_mask,
    float* vals, float* stats, int F, int G, int L, int M, long long D,
    long long n_tok, int s_bf16, int q_bf16, void* stream) {
  const Args a{mask, Q, doc_idx, tok_idx, new_mask, vals, stats, F, G, L, M,
               D, n_tok, static_cast<cudaStream_t>(stream)};
  return quant<true>(data, scales, codes, codebook, Kc, a, s_bf16, q_bf16);
}

extern "C" int colbandit_gather_maxsim_q(
    const int8_t* data, const void* scales, const int32_t* codes,
    const float* codebook, int Kc, const uint8_t* mask, const void* Q,
    const int64_t* doc_idx, const int64_t* tok_idx, float* vals, int F, int G,
    int L, int M, long long D, long long n_tok, int s_bf16, int q_bf16,
    void* stream) {
  const Args a{mask, Q, doc_idx, tok_idx, nullptr, vals, nullptr, F, G, L, M,
               D, n_tok, static_cast<cudaStream_t>(stream)};
  return quant<false>(data, scales, codes, codebook, Kc, a, s_bf16, q_bf16);
}
