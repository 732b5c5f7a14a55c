// Dense batched MaxSim for the dense rerank flavor and the exhaustive oracle,
// and its tile-masked form (sm_90a). Four entry points, one body:
//   colbandit_maxsim           replaces src/repro/kernels/maxsim.py maxsim /
//                              _maxsim_kernel
//   colbandit_maxsim_q         replaces src/repro/kernels/maxsim.py maxsim /
//                              _maxsim_q_kernel (a compressed corpus: int8
//                              rows with a per-row scale, optionally a
//                              centroid id into a codebook shared across the
//                              batch)
//   colbandit_masked_maxsim    replaces src/repro/kernels/masked_maxsim.py
//                              masked_maxsim / _masked_maxsim_kernel
//   colbandit_masked_maxsim_q  replaces src/repro/kernels/masked_maxsim.py
//                              _masked_maxsim_q_kernel
// ops.maxsim_batch_op vmapped the TPU kernels over the query batch.
//
// H[b, i, t] = max_{l valid} <E[b, i, l], Q[b, t]>, -3e38 for an
// all-masked doc. E (B, N, L, M), mask (B, N, L), Q (B, T, M) -> H (B, N, T).
// The masked form (B = 1) takes a (ceil(N/bn), ceil(T/bt)) tile mask and
// writes exactly 0 to every cell (i, t) whose tile (i/bn, t/bt) is inactive.
//
// Bound: at the serving shape (T = 32, M = 128) each doc token is read once
// and used for 2*T*M flops: 16 flop per f32 byte, just under the ~20
// flop/byte ridge of the f32 CUDA cores, so bytes and the f32 issue rate
// bound the f32 corpus about equally; an int8 corpus (~63 flop per byte)
// is bound by operations. Design: one block per (query b, doc i), with the
// batch a grid axis, so the (B, N, L, T) similarity tensor never exists.
// The block keeps a 32-token slice of its query transposed in shared
// memory, streams the doc through a 32-token shared tile (tiles with no
// valid token are skipped, so a short doc's padding is never read; a
// compressed corpus is dequantized by common.cuh's loader as the tile is
// filled, with the residual codebook staged in shared memory once per
// block), and each thread keeps 4 doc rows x 1 query token in registers: 5
// shared loads per 4 FMAs, conflict-free (the doc rows are warp-wide
// broadcasts, the query column is lane-contiguous). A running max per
// query token lives in a register; the 8 warps' maxima meet in shared
// memory at the end. Each dot is a sequential FMA chain over M, so a cell's
// value is independent of the launch shape.
//
// Tile masking: the masked kernel runs the same body with three decisions,
// each uniform across the block (a thread-divergent exit would deadlock the
// next barrier). A doc whose row of tiles is all inactive writes zeros and
// returns before it reads the doc or stages the codebook; a 32-token pass
// with no active tile writes zeros and is skipped; any other pass is
// computed as in the dense kernel and each cell is written as v or 0. So an
// active cell equals the dense kernel's bit for bit. At T = 32 one pass
// covers a doc's whole row of tiles, so only docs with no active tile save
// work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                 // doc rows per thread
constexpr int kTileL = kWarps * kRows;   // doc tokens per shared tile
constexpr int kColT = 32;                // query tokens per pass, one per lane

// A (ceil(N/bn), gj = ceil(T/bt)) bool tile mask, row-major; m is nullptr
// for the dense kernel.
struct TileMask {
  const uint8_t* m;
  int bn, bt, gj;
};

template <bool kMasked, typename Rows, typename TQ>
__device__ __forceinline__ void maxsim_body(Rows rows,
                                            const uint8_t* __restrict__ mask,
                                            const TQ* __restrict__ Qb,
                                            float* __restrict__ H, int N,
                                            int L, int M, int T,
                                            TileMask tiles) {
  extern __shared__ float smem[];
  float* q_s = smem;                        // (M, kColT) query slice, transposed
  float* e_s = q_s + (size_t)M * kColT;     // (kTileL, M) doc token tile
  float* red = e_s + (size_t)kTileL * M;    // (kWarps, kColT) per-warp maxima
  float* cb_s = red + kWarps * kColT;       // (Kc, M) codebook, residual only

  const int64_t doc = (int64_t)blockIdx.y * N + blockIdx.x;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const uint8_t* m_doc = mask + doc * L;
  const TQ* q_b = Qb + (int64_t)blockIdx.y * T * M;
  float* h_doc = H + doc * T;
  const uint8_t* tile_row =
      kMasked ? tiles.m + (int64_t)(blockIdx.x / tiles.bn) * tiles.gj
              : nullptr;
  if constexpr (kMasked) {
    int any = 0;
    for (int j = tid; j < tiles.gj; j += kThreads) any |= tile_row[j];
    if (!__syncthreads_or(any)) {  // uniform: the whole block returns
      for (int t = tid; t < T; t += kThreads) h_doc[t] = 0.f;
      return;
    }
  }
  stage_codebook(rows, cb_s, tid, kThreads);  // read after the first barrier

  for (int t0 = 0; t0 < T; t0 += kColT) {
    const int tc = min(kColT, T - t0);
    bool active = true;  // this thread's output cell t0 + tid, if tid < tc
    if constexpr (kMasked) {
      active = tid < tc && tile_row[(t0 + tid) / tiles.bt];
      // Also the barrier after which the previous pass is done with q_s and
      // red; uniform, so the skip is too.
      if (!__syncthreads_or(active)) {
        if (tid < tc) h_doc[t0 + tid] = 0.f;
        continue;
      }
    } else {
      __syncthreads();  // the previous pass is done with q_s and red
    }
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
        const int r = i / M;
        e_s[i] = r < lc ? rows.row(doc * L + l0 + r, cb_s)(i - r * M) : 0.f;
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
      h_doc[t0 + tid] = active ? v : 0.f;
    }
  }
}

// Two kernel names, so a profile tells the dense launches from the masked.
template <typename Rows, typename TQ>
__global__ void __launch_bounds__(kThreads)
maxsim_kernel(Rows rows, const uint8_t* __restrict__ mask,
              const TQ* __restrict__ Qb, float* __restrict__ H, int N, int L,
              int M, int T, TileMask tiles) {
  maxsim_body<false>(rows, mask, Qb, H, N, L, M, T, tiles);
}

template <typename Rows, typename TQ>
__global__ void __launch_bounds__(kThreads)
masked_maxsim(Rows rows, const uint8_t* __restrict__ mask,
              const TQ* __restrict__ Qb, float* __restrict__ H, int N, int L,
              int M, int T, TileMask tiles) {
  maxsim_body<true>(rows, mask, Qb, H, N, L, M, T, tiles);
}

struct Args {
  const uint8_t* mask;
  const void* Q;
  float* H;
  int B, N, L, M, T;
  TileMask tiles;  // tiles.m == nullptr: the dense kernel
  cudaStream_t stream;
};

template <typename Rows, typename TQ>
int launch(const Rows& rows, const Args& a) {
  const size_t smem = ((size_t)a.M * kColT + (size_t)kTileL * a.M +
                       kWarps * kColT + codebook_floats(rows)) *
                      sizeof(float);
  auto kernel =
      a.tiles.m ? &masked_maxsim<Rows, TQ> : &maxsim_kernel<Rows, TQ>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.N, a.B), kThreads, smem, a.stream>>>(
      rows, a.mask, static_cast<const TQ*>(a.Q), a.H, a.N, a.L, a.M, a.T,
      a.tiles);
  return (int)cudaGetLastError();
}

template <typename Rows>
int by_query(const Rows& rows, const Args& a, int q_bf16) {
  if (q_bf16) return launch<Rows, __nv_bfloat16>(rows, a);
  return launch<Rows, float>(rows, a);
}

template <typename TS>
int quant_scales(const int8_t* data, const void* scales, const int32_t* codes,
                 const float* codebook, int Kc, const Args& a, int q_bf16) {
  const TS* s = static_cast<const TS*>(scales);
  if (codes != nullptr)
    return by_query<QuantRows<TS, true>>({data, s, codes, codebook, a.M, Kc},
                                         a, q_bf16);
  return by_query<QuantRows<TS, false>>({data, s, nullptr, nullptr, a.M, 0},
                                        a, q_bf16);
}

Args dense_args(const uint8_t* mask, const void* Q, float* H, int B, int N,
                int L, int M, int T, void* stream) {
  return Args{mask, Q, H, B, N, L, M, T, TileMask{nullptr, 1, 1, 0},
              static_cast<cudaStream_t>(stream)};
}

// One query (B = 1); tile_mask is (ceil(N/bn), ceil(T/bt)) bool.
Args masked_args(const uint8_t* mask, const void* Q, const uint8_t* tile_mask,
                 float* H, int N, int L, int M, int T, int bn, int bt,
                 void* stream) {
  return Args{mask, Q, H, 1, N, L, M, T,
              TileMask{tile_mask, bn, bt, (T + bt - 1) / bt},
              static_cast<cudaStream_t>(stream)};
}

int dense_corpus(const void* E, const Args& a, int e_bf16, int q_bf16) {
  if (e_bf16)
    return by_query<DenseRows<__nv_bfloat16>>(
        {static_cast<const __nv_bfloat16*>(E), a.M}, a, q_bf16);
  return by_query<DenseRows<float>>({static_cast<const float*>(E), a.M}, a,
                                    q_bf16);
}

int quant_corpus(const int8_t* data, const void* scales, const int32_t* codes,
                 const float* codebook, int Kc, const Args& a, int s_bf16,
                 int q_bf16) {
  if (s_bf16)
    return quant_scales<__nv_bfloat16>(data, scales, codes, codebook, Kc, a,
                                       q_bf16);
  return quant_scales<float>(data, scales, codes, codebook, Kc, a, q_bf16);
}

}  // namespace

extern "C" int colbandit_maxsim(const void* E, const uint8_t* mask,
                                const void* Q, float* H, int B, int N, int L,
                                int M, int T, int e_bf16, int q_bf16,
                                void* stream) {
  return dense_corpus(E, dense_args(mask, Q, H, B, N, L, M, T, stream),
                      e_bf16, q_bf16);
}

// codes and codebook are nullptr for the int8 format (Kc ignored); the
// codebook is shared by every (b, i).
extern "C" int colbandit_maxsim_q(const int8_t* data, const void* scales,
                                  const int32_t* codes, const float* codebook,
                                  int Kc, const uint8_t* mask, const void* Q,
                                  float* H, int B, int N, int L, int M, int T,
                                  int s_bf16, int q_bf16, void* stream) {
  return quant_corpus(data, scales, codes, codebook, Kc,
                      dense_args(mask, Q, H, B, N, L, M, T, stream), s_bf16,
                      q_bf16);
}

extern "C" int colbandit_masked_maxsim(const void* E, const uint8_t* mask,
                                       const void* Q,
                                       const uint8_t* tile_mask, float* H,
                                       int N, int L, int M, int T, int bn,
                                       int bt, int e_bf16, int q_bf16,
                                       void* stream) {
  return dense_corpus(
      E, masked_args(mask, Q, tile_mask, H, N, L, M, T, bn, bt, stream),
      e_bf16, q_bf16);
}

extern "C" int colbandit_masked_maxsim_q(
    const int8_t* data, const void* scales, const int32_t* codes,
    const float* codebook, int Kc, const uint8_t* mask, const void* Q,
    const uint8_t* tile_mask, float* H, int N, int L, int M, int T, int bn,
    int bt, int s_bf16, int q_bf16, void* stream) {
  return quant_corpus(
      data, scales, codes, codebook, Kc,
      masked_args(mask, Q, tile_mask, H, N, L, M, T, bn, bt, stream), s_bf16,
      q_bf16);
}
