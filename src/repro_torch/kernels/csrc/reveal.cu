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
// path's G = 1 (init reveal) and G = 8 (rounds). What holds a launch back
// is latency: F = 128 rows give one block per SM, so each block must get
// its whole doc in flight at once, and a cell is a 128-deep FMA chain.
//
// Design. One block per frontier row f (256 threads, or 128 at block_l =
// 32, the default for a launch of more than 512 rows: Shape below; the
// cells do not depend on it) reads its own doc_idx[f] (the TPU
// kernel's scalar prefetch), so no (F, L, M) gathered copy ever reaches
// device memory. Its tok_idx and new_mask rows are read beside doc_idx,
// so no dependent load waits on them later.
//  1. The doc's mask row is read once and its valid tokens are compacted
//     into a list in shared memory (a warp ballot per 32 tokens), so
//     masked tokens are never read and a mask with holes costs nothing.
//  2. The valid rows are staged in chunks of kChunk = 64 tokens (32 in
//     the 128-thread shape) into two shared buffers with cp.async
//     (async_copy.cuh): every thread issues 16-byte copies, and the first
//     two chunks (128 tokens, a whole serving doc, in the 256-thread shape)
//     are requested before anything is used. Rows stay in their stored
//     type: an int8 chunk costs M bytes a row, with its scale and code
//     staged beside it. A row whose address is not 16-byte
//     aligned (M = 100 int8 rows are 100 bytes) is copied in 8- or 4-byte
//     pieces, and in plain 2- or 1-byte loads below that. A staged row is
//     padded by 16 bytes, so the 16-byte reads of 8 threads on 8 rows
//     fall in distinct banks.
//  3. While the copies fly, the selected query rows are gathered into
//     shared memory transposed, (M, gp) with the rows padded to gp, a
//     multiple of 4, so one float4 read serves 4 query rows as a warp
//     broadcast (and a thread holds one 16-byte row piece and 4 sums); the
//     residual codebook is staged with rows padded to M + 4 floats, so
//     threads on 8 different centroids read 8 different banks, where the
//     whole layout fits a block's shared memory (kSharedMemBytes: Kc up to
//     ~390 at L = M = 128). A larger codebook is not staged: the dot reads
//     its centroid row from global memory through the read-only path
//     (__ldg; an L2-resident 512 KB at Kc = 1,024, M = 128). The value of
//     each element is the same f32 either way.
//  4. Thread t owns token lane t % kChunk of every chunk and the batches
//     of 4 query rows b = t / kChunk + 4p (p < 4, 64 rows). A cell's dot is
//     one sequential fmaf chain over m = 0..M-1 from 0.f, of the row element
//     (dequantized by the loader's `at` formula) times the query element:
//     exactly the dense maxsim body's per-cell arithmetic (maxsim.cu), so a
//     revealed cell equals the dense kernel's cell bit for bit and depends
//     on neither F, G nor the cell's row or slot. A running nan_max per
//     cell stays in registers across chunks; at the end of the row one
//     warp xor-shuffle tree and one pass over the warps of each batch
//     give vals. nan_max lets a NaN win in any order. At G = 1 a thread
//     computes the one query row alone, not a batch of 4 with 3 padding.
// G above kMaxG = 64 query rows runs in chunks of 64 rows: for each chunk
// the block restages the chunk's query rows and walks the doc's chunks
// again (steps 2-5), so the registers and shared memory stay those of 64
// rows. Thread 0 sums the stats serially in ascending g with no FMA
// contraction, carrying its three sums across G chunks in shared memory:
// the plain PyTorch version (kernels/reveal.py::reveal_stats) repeats that
// order exactly, whatever G. Out-of-range indices and codes are clamped, as an XLA
// gather does. Every barrier is reached by all threads: the chunk loop's
// trip count is uniform (the valid-token count), and per-thread work sits
// between barriers. The shared-memory layout has one definition,
// layout(), read by the launch and exported to the Python wrappers'
// check as colbandit_reveal_smem_bytes.
#include "async_copy.cuh"
#include "common.cuh"

namespace {

constexpr int kGW = 4;     // query rows per batch (one float4)
constexpr int kMaxG = 64;  // query rows per G chunk

// A block shape: threads per block, valid tokens per staged chunk and
// chunks in flight. Thread t owns token lane t % kChunk and batches
// t / kChunk + kBatchLanes * p, p < kPasses.
template <int kThreads_, int kChunk_, int kBufs_, int kMinBlocks_>
struct Shape {
  static constexpr int kThreads = kThreads_;
  // Blocks per SM the register budget is set for (launch bounds).
  static constexpr int kMinBlocks = kMinBlocks_;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kChunk = kChunk_;
  static constexpr int kBufs = kBufs_;
  static constexpr int kBatchLanes = kThreads / kChunk;
  static constexpr int kPasses = kMaxG / (kGW * kBatchLanes);
  static constexpr int kWarpsPerBatch = kChunk / 32;
  static_assert(kPasses * kGW * kBatchLanes == kMaxG, "uneven batches");
};
// Few rows (a round: F = 128 on 132 SMs) leave one block per SM, which
// must hold a whole serving doc in flight: 256 threads, 64-token chunks.
// Many rows (the init reveal: F = 4096) are better served by more, smaller
// blocks per SM, each waiting on its own doc: 128 threads, 32 tokens.
// Both keep a thread to 80 registers: 3 and 6 blocks fit per SM.
// The shape is a launch argument, block_l (valid tokens per staged chunk):
// 64 takes Wide, 32 Narrow, and 0 the rule by F below.
using Wide = Shape<256, 64, 2, 3>;
using Narrow = Shape<128, 32, 2, 6>;
constexpr int kNarrowRows = 512;  // block_l 0: F above this takes Narrow

// The block_l a launch of F frontier rows runs at: block_l itself, or for 0
// the rule by F; 0 where block_l names no shape.
__host__ inline int resolve_block_l(int F, int block_l) {
  if (block_l == 0) return F > kNarrowRows ? Narrow::kChunk : Wide::kChunk;
  return block_l == Wide::kChunk || block_l == Narrow::kChunk ? block_l : 0;
}

// fn(Shape{}) with the shape of a resolved block_l (64 or 32).
template <typename Fn>
__host__ auto by_shape(int block_l, Fn fn) {
  return block_l == Narrow::kChunk ? fn(Narrow{}) : fn(Wide{});
}

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Byte offsets of one block's shared-memory regions.
struct Layout {
  int gp;          // rows of a G chunk rounded up to a multiple of kGW
  int stride;      // bytes of one staged doc row
  int cb_stride;   // floats of one staged codebook row
  bool cb_staged;  // the codebook is staged (else read from global memory)
  size_t q, tq, nm, buf, tok, sc, cd, red, v, st, cnt, cb, total;
};

// esz: bytes of one stored row element; scaled: rows carry a scale; Kc:
// codebook rows (0 without one). The codebook comes last and is staged
// only where the whole layout stays within kSharedMemBytes; the launch
// picks the kernel that reads it from global memory otherwise.
template <typename S>
__host__ __device__ inline Layout layout(int G, int L, int M, int esz,
                                         bool scaled, int Kc) {
  Layout o;
  const int gc = G < kMaxG ? G : kMaxG;  // rows of the widest G chunk
  o.gp = gc > 0 ? (gc + kGW - 1) / kGW * kGW : kGW;
  o.stride = static_cast<int>(align16((size_t)M * esz)) + 16;
  o.cb_stride = M + 4;
  size_t at = 0;
  o.q = at;    // (M, gp) f32 query rows of a G chunk, transposed; padded
  at += (size_t)M * o.gp * 4;  // rows are zero
  o.tq = at;   // (gp,) int64 clamped query row ids of the G chunk
  at += align16((size_t)o.gp * 8);
  o.nm = at;   // (gp,) new_mask bytes of the G chunk
  at += align16((size_t)o.gp);
  o.buf = at;  // kBufs x (kChunk, stride) staged rows
  at += (size_t)S::kBufs * S::kChunk * o.stride;
  o.tok = at;  // (L,) int32 valid token ids, compacted
  at += align16((size_t)L * 4);
  o.sc = at;   // (L,) f32 scales of the valid tokens
  at += scaled ? align16((size_t)L * 4) : 0;
  o.cd = at;   // (L,) int32 clamped codes of the valid tokens
  at += Kc > 0 ? align16((size_t)L * 4) : 0;
  o.red = at;  // (kWarpsPerBatch, gp) per-warp maxima
  at += align16((size_t)S::kWarpsPerBatch * o.gp * 4);
  o.v = at;    // (gp,) finished values
  at += align16((size_t)o.gp * 4);
  o.st = at;   // 3 f32 running stats across G chunks (thread 0)
  at += 16;
  o.cnt = at;  // (kWarps,) valid tokens per warp in a compaction pass
  at += align16((size_t)S::kWarps * 4);
  o.cb = at;   // (Kc, cb_stride) f32 codebook, where it fits
  const size_t cb_bytes = align16((size_t)Kc * o.cb_stride * 4);
  o.cb_staged = Kc > 0 && at + cb_bytes <= kSharedMemBytes;
  at += o.cb_staged ? cb_bytes : 0;
  o.total = at;
  return o;
}

// The valid token ids of one doc's mask row, ascending, into tok_s;
// returns their count (the same in every thread). At least one pass runs,
// so its barriers also publish what the block stored before the call.
template <typename S>
__device__ __forceinline__ int compact_valid(const uint8_t* m_doc, int L,
                                             int* tok_s, int* cnt_s,
                                             int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  int n = 0;
  for (int l0 = 0; l0 == 0 || l0 < L; l0 += S::kThreads) {
    const int l = l0 + tid;
    const bool valid = l < L && m_doc[l] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) cnt_s[warp] = __popc(bal);
    __syncthreads();
    int base = n, total = 0;
    for (int w = 0; w < S::kWarps; ++w) {
      const int c = cnt_s[w];
      base += w < warp ? c : 0;
      total += c;
    }
    if (valid) tok_s[base + __popc(bal & ((1u << lane) - 1u))] = l;
    n += total;
    __syncthreads();  // cnt_s is reused; tok_s is complete
  }
  return n;
}

// Start copying rows tok[0..n_k) of the doc (corpus rows row0 + tok[j])
// into the staged rows of dst, in pieces of gran bytes (every row address
// and the row length are multiples of gran). The caller commits the group.
template <typename S, typename Rows>
__device__ __forceinline__ void stage_chunk(const Rows& rows,
                                            unsigned char* dst,
                                            const int* tok, int n_k,
                                            int64_t row0, int row_bytes,
                                            int stride, int gran, int tid) {
  const int pieces = row_bytes / gran;
  for (int i = tid; i < n_k * pieces; i += S::kThreads) {
    const int j = i / pieces, pc = i - j * pieces;
    const unsigned char* from =
        reinterpret_cast<const unsigned char*>(rows.raw(row0 + tok[j])) +
        (size_t)pc * gran;
    unsigned char* to = dst + (size_t)j * stride + (size_t)pc * gran;
    switch (gran) {
      case 16: copy_async<16>(to, from); break;
      case 8: copy_async<8>(to, from); break;
      case 4: copy_async<4>(to, from); break;
      case 2:
        *reinterpret_cast<uint16_t*>(to) =
            *reinterpret_cast<const uint16_t*>(from);
        break;
      default: *to = *from;
    }
  }
}

// acc[k] = fmaf(ev, q[k], acc[k]) for the W query values at q.
template <int W>
__device__ __forceinline__ void fma_query(float ev, const float* q,
                                          float (&acc)[W]) {
  if constexpr (W == kGW) {
    const float4 qv = *reinterpret_cast<const float4*>(q);
    acc[0] = fmaf(ev, qv.x, acc[0]);
    acc[1] = fmaf(ev, qv.y, acc[1]);
    acc[2] = fmaf(ev, qv.z, acc[2]);
    acc[3] = fmaf(ev, qv.w, acc[3]);
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) acc[k] = fmaf(ev, q[k], acc[k]);
  }
}

// acc[k] = sequential fmaf chain over m of element m of staged row e
// (scale s, centroid row c) times q[m * gp + k], k < W (1 or kGW). The
// row is read 16 bytes at a time. kCbGlobal: c lies in global memory and
// its elements are read through the read-only path beside the row's.
template <typename Rows, int W, bool kCbGlobal>
__device__ __forceinline__ void dot_row(const typename Rows::Elem* e,
                                        float s, const float* c,
                                        const float* q, int gp, int M,
                                        float (&acc)[W]) {
  using Elem = typename Rows::Elem;
  constexpr int kVec = 16 / sizeof(Elem);
#pragma unroll
  for (int k = 0; k < W; ++k) acc[k] = 0.f;
  int m = 0;
  for (; m + kVec <= M; m += kVec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(e + m);
    const Elem* x = reinterpret_cast<const Elem*>(&raw);
    if constexpr (kCbGlobal) {
      float cv[kVec];  // centroid elements m .. m + kVec - 1
#pragma unroll
      for (int v = 0; v < kVec; ++v) cv[v] = __ldg(c + m + v);
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        fma_query<W>(Rows::at(x[v], s, cv, v), q + (size_t)(m + v) * gp,
                     acc);
    } else {
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        fma_query<W>(Rows::at(x[v], s, c, m + v), q + (size_t)(m + v) * gp,
                     acc);
    }
  }
  for (; m < M; ++m) {
    if constexpr (kCbGlobal) {
      const float cv = __ldg(c + m);
      fma_query<W>(Rows::at(e[m], s, &cv, 0), q + (size_t)m * gp, acc);
    } else {
      fma_query<W>(Rows::at(e[m], s, c, m), q + (size_t)m * gp, acc);
    }
  }
}

// The shape comes last, so a profile's kernel name still starts with
// reveal_kernel<DenseRows or reveal_kernel<QuantRows. kCbGlobal: the
// layout leaves the codebook in global memory (layout().cb_staged false).
template <typename Rows, typename TQ, bool kStats, bool kCbGlobal, typename S>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks)
reveal_kernel(Rows rows, const uint8_t* __restrict__ mask,
              const TQ* __restrict__ Qt, const int64_t* __restrict__ doc_idx,
              const int64_t* __restrict__ tok_idx,
              const uint8_t* __restrict__ new_mask, float* __restrict__ vals,
              float* __restrict__ stats, int G, int L, int M, int64_t D,
              int64_t TQn, int Kc, int gran) {
  using Elem = typename Rows::Elem;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout o = layout<S>(G, L, M, sizeof(Elem), Rows::kScaled, Kc);
  const int gp = o.gp;
  float* q_s = reinterpret_cast<float*>(smem + o.q);
  int64_t* tq_s = reinterpret_cast<int64_t*>(smem + o.tq);
  uint8_t* nm_s = smem + o.nm;
  unsigned char* buf = smem + o.buf;
  float* cb_s = reinterpret_cast<float*>(smem + o.cb);
  int* tok_s = reinterpret_cast<int*>(smem + o.tok);
  float* sc_s = reinterpret_cast<float*>(smem + o.sc);
  int* cd_s = reinterpret_cast<int*>(smem + o.cd);
  float* red = reinterpret_cast<float*>(smem + o.red);
  float* v_s = reinterpret_cast<float*>(smem + o.v);
  float* st_s = reinterpret_cast<float*>(smem + o.st);
  int* cnt_s = reinterpret_cast<int*>(smem + o.cnt);

  const int64_t f = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int64_t d = doc_idx[f];
  d = d < 0 ? 0 : (d >= D ? D - 1 : d);
  const int64_t row0 = d * L;
  // The query row ids and new_mask bytes of G chunk [g0, g0 + gc).
  auto load_ids = [&](int g0, int gc) {
    for (int g = tid; g < gc; g += S::kThreads) {
      const int64_t t = tok_idx[f * G + g0 + g];
      tq_s[g] = t < 0 ? 0 : (t >= TQn ? TQn - 1 : t);
      if (kStats) nm_s[g] = new_mask[f * G + g0 + g];
    }
  };
  // The first chunk's, beside doc_idx, not after it.
  load_ids(0, min(G, kMaxG));

  // 1. the doc's valid tokens (its barriers publish the ids).
  const int n = compact_valid<S>(mask + row0, L, tok_s, cnt_s, tid);
  const int nc = (n + S::kChunk - 1) / S::kChunk;
  const int row_bytes = M * static_cast<int>(sizeof(Elem));
  const size_t buf_bytes = (size_t)S::kChunk * o.stride;
  const int j = tid % S::kChunk, b0 = tid / S::kChunk;
  for (int g0 = 0; g0 < G; g0 += kMaxG) {
    const int gc = min(kMaxG, G - g0);
    if (g0 > 0) {
      __syncthreads();  // the last chunk's q_s, tq_s, nm_s, red, v_s are read
      load_ids(g0, gc);
      __syncthreads();
    }
    // 2. the doc's first chunks in flight.
    for (int k = 0; k < S::kBufs; ++k) {
      const int n_k = min(S::kChunk, max(0, n - k * S::kChunk));
      stage_chunk<S>(rows, buf + k * buf_bytes, tok_s + k * S::kChunk, n_k,
                     row0, row_bytes, o.stride, gran, tid);
      copy_async_commit();
    }

    // 3. while they fly: query rows (ids from tq_s, so a thread's loads are
    // independent), and once per block codebook, scales and codes.
#pragma unroll 4
    for (int i = tid; i < gp * M; i += S::kThreads) {
      const int g = i / M, m = i - g * M;
      q_s[m * gp + g] = g < gc ? to_f32(Qt[tq_s[g] * M + m]) : 0.f;
    }
    if (g0 == 0) {
      if constexpr (Rows::kCodebook && !kCbGlobal) {
        for (int i = tid; i < Kc * M; i += S::kThreads) {
          const int k = i / M;
          cb_s[k * o.cb_stride + (i - k * M)] = rows.codebook[i];
        }
      }
      if constexpr (Rows::kScaled) {
        for (int i = tid; i < n; i += S::kThreads) {
          const int64_t r = row0 + tok_s[i];
          sc_s[i] = rows.scale(r);
          if constexpr (Rows::kCodebook) cd_s[i] = rows.code(r);
        }
      }
    }

    // 4. chunk k computes while the next ones land.
    float run[S::kPasses][kGW];
#pragma unroll
    for (int p = 0; p < S::kPasses; ++p)
#pragma unroll
      for (int k = 0; k < kGW; ++k) run[p][k] = COLBANDIT_NEG;
    const int nb = (gc + kGW - 1) / kGW;
    for (int k = 0; k < nc; ++k) {
      copy_async_wait<S::kBufs - 1>();  // this thread's chunk k has landed
      __syncthreads();  // everyone's has, and step 3 is done
      const int k0 = k * S::kChunk, n_k = min(S::kChunk, n - k0);
      unsigned char* cur = buf + (k % S::kBufs) * buf_bytes;
      if (j < n_k) {
        const Elem* e =
            reinterpret_cast<const Elem*>(cur + (size_t)j * o.stride);
        float s = 1.f;
        const float* c = nullptr;
        if constexpr (Rows::kScaled) s = sc_s[k0 + j];
        if constexpr (Rows::kCodebook) {
          c = kCbGlobal ? rows.codebook + (size_t)cd_s[k0 + j] * M
                        : cb_s + cd_s[k0 + j] * o.cb_stride;
        }
        if (gc == 1) {  // uniform: no padded query rows, one thread a token
          if (b0 == 0) {
            float acc[1];
            dot_row<Rows, 1, kCbGlobal>(e, s, c, q_s, gp, M, acc);
            run[0][0] = nan_max(run[0][0], acc[0]);
          }
        } else {
#pragma unroll
          for (int p = 0; p < S::kPasses; ++p) {
            const int b = b0 + S::kBatchLanes * p;
            if (b < nb) {
              float acc[kGW];
              dot_row<Rows, kGW, kCbGlobal>(e, s, c, q_s + b * kGW, gp, M,
                                            acc);
#pragma unroll
              for (int q = 0; q < kGW; ++q)
                run[p][q] = nan_max(run[p][q], acc[q]);
            }
          }
        }
      }
      __syncthreads();  // chunk k's buffer is free
      const int k2 = k + S::kBufs;
      const int n_next = min(S::kChunk, max(0, n - k2 * S::kChunk));
      stage_chunk<S>(rows, cur, tok_s + k2 * S::kChunk, n_next, row0,
                     row_bytes, o.stride, gran, tid);
      copy_async_commit();
    }

    // 5. one warp tree per cell, then the warps of each batch meet.
    const int h = warp % S::kWarpsPerBatch;
#pragma unroll
    for (int p = 0; p < S::kPasses; ++p) {
      const int b = b0 + S::kBatchLanes * p;  // warp-uniform
      if (b < nb) {
#pragma unroll
        for (int q = 0; q < kGW; ++q) {
          float x = run[p][q];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, off));
          if (lane == 0) red[h * gp + b * kGW + q] = x;
        }
      }
    }
    __syncthreads();
    for (int g = tid; g < gc; g += S::kThreads) {
      float v = red[g];
      for (int w = 1; w < S::kWarpsPerBatch; ++w)
        v = nan_max(v, red[w * gp + g]);
      vals[f * G + g0 + g] = v;
      v_s[g] = v;
    }
    if (kStats) {
      __syncthreads();
      if (tid == 0) {
        float cnt = 0.f, tot = 0.f, sq = 0.f;
        if (g0 > 0) {
          cnt = st_s[0];
          tot = st_s[1];
          sq = st_s[2];
        }
        for (int g = 0; g < gc; ++g) {
          const bool fresh = nm_s[g] != 0;
          const float v = v_s[g];
          // vm * v, not new * v * v: an all-masked doc's -3e38 squared
          // would overflow to inf and 0 * inf is NaN.
          const float vm = fresh ? v : 0.f;
          cnt = __fadd_rn(cnt, fresh ? 1.f : 0.f);
          tot = __fadd_rn(tot, vm);
          sq = __fadd_rn(sq, __fmul_rn(vm, v));
        }
        st_s[0] = cnt;
        st_s[1] = tot;
        st_s[2] = sq;
      }
    }
  }
  if (kStats && tid == 0) {  // thread 0 wrote st_s itself
    stats[f * 3 + 0] = G > 0 ? st_s[0] : 0.f;
    stats[f * 3 + 1] = G > 0 ? st_s[1] : 0.f;
    stats[f * 3 + 2] = G > 0 ? st_s[2] : 0.f;
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
  int block_l;  // as given: 64, 32, or 0 for the rule by F
  cudaStream_t stream;
};

// The widest copy (16, 8, 4, 2 or 1 bytes) that every row start honours.
int copy_granularity(const void* base, int row_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base) |
                      static_cast<uintptr_t>(row_bytes);
  int g = 16;
  while (g > 1 && (a & (g - 1))) g >>= 1;
  return g;
}

template <typename Rows>
int codebook_rows(const Rows& rows) {
  if constexpr (Rows::kCodebook) {
    return rows.Kc;
  } else {
    return 0;
  }
}

template <typename S, typename Rows, typename TQ, bool kStats, bool kCbGlobal>
int launch_kernel(const Rows& rows, const Args& a, int kc, size_t smem) {
  using Elem = typename Rows::Elem;
  auto kernel = reveal_kernel<Rows, TQ, kStats, kCbGlobal, S>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.F, S::kThreads, smem, a.stream>>>(
      rows, a.mask, static_cast<const TQ*>(a.Q), a.doc_idx, a.tok_idx,
      a.new_mask, a.vals, a.stats, a.G, a.L, a.M, a.D, a.n_tok, kc,
      copy_granularity(rows.raw(0), a.M * (int)sizeof(Elem)));
  return (int)cudaGetLastError();
}

// The kernel the layout asks for: the codebook staged or left in global
// memory, the one decision of layout() that the size query reports too.
template <typename S, typename Rows, typename TQ, bool kStats>
int launch_shape(const Rows& rows, const Args& a) {
  using Elem = typename Rows::Elem;
  const int kc = codebook_rows(rows);
  const Layout o =
      layout<S>(a.G, a.L, a.M, sizeof(Elem), Rows::kScaled, kc);
  if constexpr (Rows::kCodebook) {
    if (!o.cb_staged)
      return launch_kernel<S, Rows, TQ, kStats, true>(rows, a, kc, o.total);
  }
  return launch_kernel<S, Rows, TQ, kStats, false>(rows, a, kc, o.total);
}

template <typename Rows, typename TQ, bool kStats>
int launch(const Rows& rows, const Args& a) {
  const int bl = resolve_block_l(a.F, a.block_l);
  if (a.G < 0 || bl == 0) return (int)cudaErrorInvalidValue;
  return by_shape(bl, [&](auto shape) {
    return launch_shape<decltype(shape), Rows, TQ, kStats>(rows, a);
  });
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

// Bytes of shared memory one block of a launch of F frontier rows at
// block_l (as the entry points take it) takes for G query rows per
// frontier row, docs of L tokens of M elements of elem_bytes bytes (4 f32,
// 2 bf16, 1 int8), scaled rows (the _q entry points) and Kc codebook rows
// (0 without one): the launch's own layout(), with the codebook staged
// only where it fits; -1 where G is negative, -2 where block_l names no
// shape. Any G >= 0 runs (in chunks of 64 query rows).
extern "C" long long colbandit_reveal_smem_bytes(int F, int G, int L, int M,
                                                 int elem_bytes, int scaled,
                                                 int Kc, int block_l) {
  if (G < 0) return -1;
  const int bl = resolve_block_l(F, block_l);
  if (bl == 0) return -2;
  return by_shape(bl, [&](auto shape) {
    return (long long)layout<decltype(shape)>(G, L, M, elem_bytes,
                                              scaled != 0, Kc)
        .total;
  });
}

extern "C" int colbandit_fused_reveal(const void* E, const uint8_t* mask,
                                      const void* Q, const int64_t* doc_idx,
                                      const int64_t* tok_idx,
                                      const uint8_t* new_mask, float* vals,
                                      float* stats, int F, int G, int L, int M,
                                      long long D, long long n_tok, int e_bf16,
                                      int q_bf16, int block_l, void* stream) {
  const Args a{mask, Q, doc_idx, tok_idx, new_mask, vals, stats, F, G, L, M,
               D, n_tok, block_l, static_cast<cudaStream_t>(stream)};
  return dense<true>(E, a, e_bf16, q_bf16);
}

extern "C" int colbandit_gather_maxsim(const void* E, const uint8_t* mask,
                                       const void* Q, const int64_t* doc_idx,
                                       const int64_t* tok_idx, float* vals,
                                       int F, int G, int L, int M, long long D,
                                       long long n_tok, int e_bf16, int q_bf16,
                                       int block_l, void* stream) {
  const Args a{mask, Q, doc_idx, tok_idx, nullptr, vals, nullptr, F, G, L, M,
               D, n_tok, block_l, static_cast<cudaStream_t>(stream)};
  return dense<false>(E, a, e_bf16, q_bf16);
}

// codes and codebook are nullptr for the int8 format (Kc ignored).
extern "C" int colbandit_fused_reveal_q(
    const int8_t* data, const void* scales, const int32_t* codes,
    const float* codebook, int Kc, const uint8_t* mask, const void* Q,
    const int64_t* doc_idx, const int64_t* tok_idx, const uint8_t* new_mask,
    float* vals, float* stats, int F, int G, int L, int M, long long D,
    long long n_tok, int s_bf16, int q_bf16, int block_l, void* stream) {
  const Args a{mask, Q, doc_idx, tok_idx, new_mask, vals, stats, F, G, L, M,
               D, n_tok, block_l, static_cast<cudaStream_t>(stream)};
  return quant<true>(data, scales, codes, codebook, Kc, a, s_bf16, q_bf16);
}

extern "C" int colbandit_gather_maxsim_q(
    const int8_t* data, const void* scales, const int32_t* codes,
    const float* codebook, int Kc, const uint8_t* mask, const void* Q,
    const int64_t* doc_idx, const int64_t* tok_idx, float* vals, int F, int G,
    int L, int M, long long D, long long n_tok, int s_bf16, int q_bf16,
    int block_l, void* stream) {
  const Args a{mask, Q, doc_idx, tok_idx, nullptr, vals, nullptr, F, G, L, M,
               D, n_tok, block_l, static_cast<cudaStream_t>(stream)};
  return quant<false>(data, scales, codes, codebook, Kc, a, s_bf16, q_bf16);
}
