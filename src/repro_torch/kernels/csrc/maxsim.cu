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
// Bound: at the serving shape (T = 32, M = 128) each valid doc token is
// read once and used for 2*T*M flops: 16 flop per f32 byte, just under the
// ~20 flop/byte ridge of the f32 CUDA cores, so bytes and the f32 issue
// rate bound the f32 corpus about equally; an int8 corpus (~63 flop per
// byte) is bound by operations. Tensor cores would break the per-cell fmaf
// chain below, and buy nothing for f32 at this ridge. The masked form is
// bound the same way over the docs it reads.
//
// The body (dense::maxsim_body). A block of 128 threads takes kDocs
// consecutive docs of one query b, grid (ceil(N / kDocs), B), so the
// (B, N, L, T) similarity tensor never exists. kDocs is a template
// parameter: the dense entry points take it as block_n (1, 2 or 4; 2 by
// default), the masked ones run at kMaskedDocs = 2.
//  1. Each warp compacts the valid tokens of one of the block's docs into a
//     list in shared memory (a ballot per 32 mask bytes), so masked tokens
//     are neither read nor computed; an all-masked doc writes -3e38 at once.
//     Scales and codes are read for all L positions beside the mask, so no
//     load waits on the list.
//  2. The block walks its docs' valid tokens in chunks of kChunk = 64, one
//     doc after another, two chunks in flight: rows are staged raw with
//     cp.async (async_copy.cuh), in 16-byte pieces where every row start
//     allows it and in 8-, 4-byte pieces or plain loads below that (M = 100
//     int8 rows are 100 bytes), so the next doc's first chunk lands while a
//     doc's last chunk is computed. f32 rows are computed where they land;
//     bf16 and int8 rows are turned into an f32 compute tile once per chunk
//     with the loader's `at` (with the residual codebook staged once per
//     block where the whole layout fits kSharedMemBytes, Kc up to 312 at
//     L = M = 128 and 2 docs a block; a larger codebook stays in global
//     memory and the tile reads its centroid rows through the read-only
//     path, __ldg, the same f32 values), so each element is dequantized
//     once, not once per reader.
//  3. The query is staged once per block and 32-token pass, row-major with
//     rows of 4 mod 32 floats (as the f32 tile's), so that tile reads of 8
//     consecutive rows fall in distinct banks. Longer queries loop over
//     passes, each re-reading the docs.
//  4. Register tiling: a warp covers 32 chunk rows x 16 query rows; lane
//     (tg, qg) = (lane % 8, lane / 8) of warp (tb, qh) = (warp / 2, warp % 2)
//     holds rows tg + 8 (2 r + tb), r < 4, against query rows
//     16 qh + qg + 4 c, c < 4: 16 accumulators. A step of 4 m reads 4 row
//     float4s (the 8 lanes of a query group on 8 consecutive rows) and 4
//     query float4s (broadcasts) for 64 FMAs. A warp computes only the
//     8-row groups that hold valid tokens.
//  5. Running maxima per query row stay in registers across a doc's chunks;
//     at the doc's end one shuffle tree over the 8 lanes of a query group
//     and one pass over the two row halves in shared memory give H.
// Two kernel names run it: maxsim_kernel (no tile mask) and masked_maxsim
// (kTiles), which skips work at three grains, each decision uniform where
// a barrier follows it (a divergent exit would deadlock the next barrier):
//  - a block none of whose docs has an active tile writes zeros and
//    returns before it reads a doc byte or stages the codebook;
//  - in a 32-token pass, a doc with no active tile over the pass's query
//    rows is left out of the block's chunk sequence (its rows are neither
//    staged nor computed) and writes zeros; a pass without such a doc is
//    skipped;
//  - a warp whose 16 query rows have no active tile of the doc skips its
//    product for that doc (warp-uniform).
// Every cell is written as its value where its tile is active and 0.f
// elsewhere; an all-masked doc gives -3e38 in its active tiles. At T = 32
// a doc's tiles form one row, so a doc is read when any of its tiles is
// active, and masked time follows the share of such docs.
// A cell's dot is one sequential fmaf chain over m = 0..M-1 from 0.f of the
// loader's element (`at`) and the f32 query element, in ascending m (a
// float4 step does its 4 fmaf in order): the reveal body's arithmetic
// (reveal.cu), so a revealed cell equals a dense cell bit for bit, a _q
// launch equals the f32 launch on the dequantized corpus, an active masked
// cell equals the dense one, and no cell depends on kDocs, the chunking,
// the tile mask or the launch shape. Every barrier is reached by every
// thread: the chunk sequence is the same in the whole block. The body's
// shared memory has one definition, dense::layout(), read by the launch
// and exported as colbandit_maxsim_smem_bytes.
#include <type_traits>

#include "async_copy.cuh"
#include "common.cuh"

namespace {

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

template <typename Rows>
int codebook_rows(const Rows& rows) {
  if constexpr (Rows::kCodebook) {
    return rows.Kc;
  } else {
    return 0;
  }
}

// The widest copy (16, 8, 4, 2 or 1 bytes) that every row start honours.
int copy_granularity(const void* base, int row_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base) |
                      static_cast<uintptr_t>(row_bytes);
  int g = 16;
  while (g > 1 && (a & (g - 1))) g >>= 1;
  return g;
}

// A (ceil(N/bn), gj = ceil(T/bt)) bool tile mask, row-major: cell (i, t)
// is active when tile (i / bn, t / bt) is. m is nullptr for the dense
// kernel, which reads none of it.
struct TileMask {
  const uint8_t* m;
  int bn, bt, gj;
  __device__ __forceinline__ const uint8_t* row(int i) const {
    return m + (int64_t)(i / bn) * gj;
  }
  __device__ __forceinline__ bool on(int i, int t) const {
    return row(i)[t / bt] != 0;
  }
};

// ---------------------------------------------------------------------------
// The body
// ---------------------------------------------------------------------------
namespace dense {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;            // register budget (launch bounds)
constexpr int kMaskedDocs = 2;           // docs per block, masked kernel
// Docs per block the dense kernel is built for (its block_n).
__host__ __device__ constexpr bool dense_docs_ok(int docs) {
  return docs == 1 || docs == 2 || docs == 4;
}
constexpr int kChunk = 64;               // valid tokens per staged chunk
constexpr int kPassT = 32;               // query rows per pass
constexpr int kHalves = kWarps / 2;      // row halves tb; query halves qh = 2
constexpr int kRowsPerThread = kChunk / (8 * kHalves);
static_assert(kRowsPerThread == 4 && kPassT == 2 * 16, "tile shape");

// Byte offsets of one block's shared-memory regions.
struct Layout {
  int ts;          // floats of one query row or f32 tile row (4 mod 32)
  int rs;          // bytes of one staged doc row
  int cbs;         // floats of one staged codebook row
  bool cb_staged;  // the codebook is staged (else read from global memory)
  size_t q, buf, tile, tok, sc, cd, red, cnt, cb, total;
};

// esz: bytes of one stored row element (4: f32 rows, computed where they
// land); scaled: rows carry a scale; Kc: codebook rows (0 without one);
// kDocs: docs per block. The codebook comes last and is staged only where
// the whole layout stays within kSharedMemBytes; the launch picks the
// kernel that reads it from global memory otherwise.
__host__ __device__ inline Layout layout(int L, int M, int esz, bool scaled,
                                         int Kc, int kDocs) {
  Layout o;
  const bool direct = esz == 4;
  o.ts = (M + 31) / 32 * 32 + 4;
  o.rs = direct ? o.ts * 4 : static_cast<int>(align16((size_t)M * esz)) + 16;
  o.cbs = (M + 3) / 4 * 4;
  size_t at = 0;
  o.q = at;     // (kPassT, ts) f32 query rows of the pass
  at += (size_t)kPassT * o.ts * 4;
  o.buf = at;   // 2 x (kChunk, rs) staged rows
  at += 2 * (size_t)kChunk * o.rs;
  o.tile = at;  // (kChunk, ts) f32 compute tile (not for f32 rows)
  at += direct ? 0 : (size_t)kChunk * o.ts * 4;
  o.tok = at;   // (kDocs, L) int32 valid token ids, compacted per doc
  at += align16((size_t)kDocs * L * 4);
  o.sc = at;    // (kDocs, L) f32 scales of every position
  at += scaled ? align16((size_t)kDocs * L * 4) : 0;
  o.cd = at;    // (kDocs, L) int32 clamped codes of every position
  at += Kc > 0 ? align16((size_t)kDocs * L * 4) : 0;
  o.red = at;   // (kHalves, kPassT) per-half maxima of a doc
  at += align16((size_t)kHalves * kPassT * 4);
  o.cnt = at;   // (kDocs,) valid tokens per doc
  at += align16((size_t)kDocs * 4);
  o.cb = at;    // (Kc, cbs) f32 codebook, where it fits
  const size_t cb_bytes = align16((size_t)Kc * o.cbs * 4);
  o.cb_staged = Kc > 0 && at + cb_bytes <= kSharedMemBytes;
  at += o.cb_staged ? cb_bytes : 0;
  o.total = at;
  return o;
}

// The valid token ids of docs warp, warp + kWarps, ... of the block (nd
// docs whose masks start at mask_b), ascending into tok_s + d * L, one warp
// a doc, with their count in cnt_s[d]. No block barrier: the caller's next
// one publishes the lists.
__device__ __forceinline__ void compact_docs(const uint8_t* mask_b, int nd,
                                             int L, int* tok_s, int* cnt_s,
                                             int lane, int warp) {
  for (int d = warp; d < nd; d += kWarps) {
    const uint8_t* md = mask_b + (int64_t)d * L;
    int* tok = tok_s + d * L;
    int n = 0;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int l = l0 + lane;
      const bool valid = l < L && md[l] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, valid);
      if (valid) tok[n + __popc(bal & ((1u << lane) - 1u))] = l;
      n += __popc(bal);
    }
    if (lane == 0) cnt_s[d] = n;
  }
}

// dst[r * stride + i] = to_f32(src[r * width + i]) for r < rows, i < width,
// and 0 for rows rows..pad_rows. A thread takes columns tid, tid + kThreads,
// ... and walks the rows, 8 loads in flight before their stores.
template <typename T>
__device__ __forceinline__ void stage_f32(float* __restrict__ dst, int stride,
                                          const T* __restrict__ src,
                                          int width, int rows, int pad_rows,
                                          int tid) {
  for (int i = tid; i < width; i += kThreads) {
#pragma unroll 8
    for (int r = 0; r < pad_rows; ++r)
      dst[(size_t)r * stride + i] =
          r < rows ? to_f32(src[(size_t)r * width + i]) : 0.f;
  }
}

// Start copying rows tok[0..n_k) of a doc (corpus rows row0 + tok[j]) into
// the staged rows of dst, in pieces of gran bytes (every row address and
// the row length are multiples of gran). The caller commits the group.
template <typename Rows>
__device__ __forceinline__ void stage_rows(const Rows& rows,
                                           unsigned char* dst, const int* tok,
                                           int n_k, int64_t row0,
                                           int row_bytes, int stride,
                                           int gran, int tid) {
  const int pieces = row_bytes / gran;
  for (int i = tid; i < n_k * pieces; i += kThreads) {
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

template <typename E>
struct alignas(4 * sizeof(E)) Pack4 {
  E v[4];
};

// The f32 compute tile of a staged chunk of n_k rows: element m of row j is
// the loader's at(raw, scale, centroid row, m) of token tok[j], computed
// once. Thread tid takes the 4-element quads tid, tid + kThreads, ... of
// the chunk, row-major; sc and cd are indexed by token position. cb is the
// staged codebook (rows of cbs floats) or, kCbGlobal, the global one (rows
// of M floats, read through the read-only path).
template <typename Rows, bool kCbGlobal>
__device__ __forceinline__ void dequant_chunk(
    const unsigned char* raw, float* tile, const int* tok, const float* sc,
    const int* cd, const float* cb, int n_k, int M, int rs, int ts,
    int cbs, int tid) {
  using Elem = typename Rows::Elem;
  const int mq = (M + 3) / 4;
  if (mq == 0) return;
  int j = tid / mq, q = tid - j * mq;
  const int dj = kThreads / mq, dq = kThreads - dj * mq;
  while (j < n_k) {
    const Elem* e = reinterpret_cast<const Elem*>(raw + (size_t)j * rs);
    const int m = 4 * q;
    float s = 1.f;
    float cv[4] = {0.f, 0.f, 0.f, 0.f};  // codebook[code][m .. m + 3]
    if constexpr (Rows::kScaled) s = sc[tok[j]];
    if constexpr (Rows::kCodebook && kCbGlobal) {
      const float* c = cb + (size_t)cd[tok[j]] * M + m;
#pragma unroll
      for (int k = 0; k < 4; ++k) cv[k] = m + k < M ? __ldg(c + k) : 0.f;
    } else if constexpr (Rows::kCodebook) {
      const float4 c4 = *reinterpret_cast<const float4*>(
          cb + (size_t)cd[tok[j]] * cbs + m);
      cv[0] = c4.x;
      cv[1] = c4.y;
      cv[2] = c4.z;
      cv[3] = c4.w;
    }
    float* out = tile + (size_t)j * ts + m;
    if (m + 4 <= M) {
      const Pack4<Elem> x = *reinterpret_cast<const Pack4<Elem>*>(e + m);
      float4 v;
      v.x = Rows::at(x.v[0], s, cv, 0);
      v.y = Rows::at(x.v[1], s, cv, 1);
      v.z = Rows::at(x.v[2], s, cv, 2);
      v.w = Rows::at(x.v[3], s, cv, 3);
      *reinterpret_cast<float4*>(out) = v;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (m + k < M) out[k] = Rows::at(e[m + k], s, cv, k);
    }
    q += dq;
    j += dj;
    if (q >= mq) {
      q -= mq;
      ++j;
    }
  }
}

// run[c] = nan_max(run[c], cell) over this thread's valid rows of a chunk of
// n_k rows: rows tg + 8 (kHalves r + tb), r < NR, of e_s against query rows
// q + 4 c * ts, c < 4. Each cell is one fmaf chain over ascending m.
template <int NR>
__device__ __forceinline__ void dot_chunk(const float* __restrict__ e_s,
                                          const float* __restrict__ q, int ts,
                                          int M, int tg, int tb, int n_k,
                                          float (&run)[4]) {
  constexpr int kRowStep = 8 * kHalves;
  const float* e = e_s + (size_t)(tg + 8 * tb) * ts;
  float acc[NR][4];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  const int m4 = M & ~3;
  int m = 0;
#pragma unroll 2
  for (; m < m4; m += 4) {
    float4 ev[NR], qv[4];
#pragma unroll
    for (int r = 0; r < NR; ++r)
      ev[r] = *reinterpret_cast<const float4*>(
          e + (size_t)r * kRowStep * ts + m);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      qv[c] = *reinterpret_cast<const float4*>(q + (size_t)c * 4 * ts + m);
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float a = acc[r][c];
        a = fmaf(ev[r].x, qv[c].x, a);
        a = fmaf(ev[r].y, qv[c].y, a);
        a = fmaf(ev[r].z, qv[c].z, a);
        a = fmaf(ev[r].w, qv[c].w, a);
        acc[r][c] = a;
      }
  }
  for (; m < M; ++m) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float x = e[(size_t)r * kRowStep * ts + m];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[r][c] = fmaf(x, q[(size_t)c * 4 * ts + m], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r)
    if (tg + 8 * (kHalves * r + tb) < n_k)
#pragma unroll
      for (int c = 0; c < 4; ++c) run[c] = nan_max(run[c], acc[r][c]);
}

// dot_chunk for the nr (0..4) 8-row groups this warp computes.
__device__ __forceinline__ void dot_rows(int nr, const float* e_s,
                                         const float* q, int ts, int M,
                                         int tg, int tb, int n_k,
                                         float (&run)[4]) {
  switch (nr) {
    case 4: dot_chunk<4>(e_s, q, ts, M, tg, tb, n_k, run); break;
    case 3: dot_chunk<3>(e_s, q, ts, M, tg, tb, n_k, run); break;
    case 2: dot_chunk<2>(e_s, q, ts, M, tg, tb, n_k, run); break;
    case 1: dot_chunk<1>(e_s, q, ts, M, tg, tb, n_k, run); break;
    default: break;
  }
}

// A place in a pass's sequence of chunks: chunk c of the valid tokens of
// doc d (of the block); d == nd past the end. The sequence's docs are the
// set bits of live: docs with a valid token (and, masked, an active tile
// in the pass).
struct Cursor {
  int d, c;
  __device__ __forceinline__ void skip_dead(unsigned live, int nd) {
    while (d < nd && !((live >> d) & 1u)) ++d;
  }
  __device__ __forceinline__ bool last_of_doc(const int* cnt_s) const {
    return (c + 1) * kChunk >= cnt_s[d];
  }
  __device__ __forceinline__ void next(const int* cnt_s, unsigned live,
                                       int nd) {
    if (last_of_doc(cnt_s)) {
      ++d;
      c = 0;
      skip_dead(live, nd);
    } else {
      ++c;
    }
  }
};

template <typename Rows, typename TQ, bool kTiles, int kDocs, bool kCbGlobal>
__device__ __forceinline__ void maxsim_body(
    Rows rows, const uint8_t* __restrict__ mask, const TQ* __restrict__ Qb,
    float* __restrict__ H, int N, int L, int M, int T, int Kc, int gran,
    TileMask tiles) {
  using Elem = typename Rows::Elem;
  constexpr bool kDirect = std::is_same<Elem, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout o = layout(L, M, sizeof(Elem), Rows::kScaled, Kc, kDocs);
  float* q_s = reinterpret_cast<float*>(smem + o.q);
  unsigned char* buf = smem + o.buf;
  float* tile = reinterpret_cast<float*>(smem + o.tile);
  float* cb_s = reinterpret_cast<float*>(smem + o.cb);
  int* tok_s = reinterpret_cast<int*>(smem + o.tok);
  float* sc_s = reinterpret_cast<float*>(smem + o.sc);
  int* cd_s = reinterpret_cast<int*>(smem + o.cd);
  float* red = reinterpret_cast<float*>(smem + o.red);
  int* cnt_s = reinterpret_cast<int*>(smem + o.cnt);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tg = lane & 7, qg = lane >> 3, tb = warp >> 1, qh = warp & 1;
  const int i0 = blockIdx.x * kDocs;
  const int nd = min(kDocs, N - i0);
  const int64_t doc0 = (int64_t)blockIdx.y * N + i0;
  const TQ* q_b = Qb + (int64_t)blockIdx.y * T * M;

  if constexpr (kTiles) {  // 0. a block with no active tile
    int any = 0;
    for (int k = tid; k < nd * tiles.gj; k += kThreads)
      any |= tiles.row(i0 + k / tiles.gj)[k % tiles.gj];
    if (!__syncthreads_or(any)) {  // uniform: the whole block returns
      for (int k = tid; k < nd * T; k += kThreads) H[doc0 * T + k] = 0.f;
      return;
    }
  }

  // 1. valid tokens; scales, codes and codebook beside them.
  compact_docs(mask + doc0 * L, nd, L, tok_s, cnt_s, lane, warp);
  if constexpr (Rows::kScaled) {
#pragma unroll 4
    for (int i = tid; i < nd * L; i += kThreads) {
      sc_s[i] = rows.scale(doc0 * L + i);
      if constexpr (Rows::kCodebook) cd_s[i] = rows.code(doc0 * L + i);
    }
  }
  const float* cb = cb_s;  // the codebook the tiles read
  if constexpr (Rows::kCodebook && kCbGlobal) cb = rows.codebook;
  if constexpr (Rows::kCodebook && !kCbGlobal)
    stage_f32(cb_s, o.cbs, rows.codebook, M, Kc, Kc, tid);
  __syncthreads();
  unsigned has = 0;  // bit d: doc d has a valid token
  for (int d = 0; d < nd; ++d) {
    if (cnt_s[d] > 0) {
      has |= 1u << d;
    } else {
      for (int t = tid; t < T; t += kThreads)
        H[(doc0 + d) * T + t] =
            kTiles && !tiles.on(i0 + d, t) ? 0.f : COLBANDIT_NEG;
    }
  }
  if (has == 0) return;  // uniform: every doc is all-masked

  const int row_bytes = M * static_cast<int>(sizeof(Elem));
  const size_t buf_bytes = (size_t)kChunk * o.rs;
  // Stage the chunk at s (none past the end) into dst and commit the group.
  auto stage = [&](const Cursor& s, unsigned char* dst) {
    const int n_k = s.d < nd ? min(kChunk, cnt_s[s.d] - s.c * kChunk) : 0;
    stage_rows(rows, dst, tok_s + s.d * L + s.c * kChunk, n_k,
               (doc0 + s.d) * L, row_bytes, o.rs, gran, tid);
    copy_async_commit();
  };
  for (int t0 = 0; t0 < T; t0 += kPassT) {
    const int tc = min(kPassT, T - t0);
    // The pass's docs (live). Masked: bit d of on is whether cell (doc d,
    // query row t0 + lane) is active; bit 2 d + h of halves whether doc d
    // has an active cell in query half h of the pass, from a ballot that
    // every warp takes alike. A doc with none is left out and writes zeros.
    unsigned live = has, halves = 0, on = 0;
    if constexpr (kTiles) {
      for (int d = 0; d < nd; ++d)
        if (((has >> d) & 1u) && lane < tc && tiles.on(i0 + d, t0 + lane))
          on |= 1u << d;
      for (int d = 0; d < nd; ++d) {
        const unsigned b = __ballot_sync(0xffffffffu, (on >> d) & 1u);
        if (b & 0xffffu) halves |= 1u << (2 * d);
        if (b >> 16) halves |= 2u << (2 * d);
        if (b == 0 && ((has >> d) & 1u)) {
          live &= ~(1u << d);
          for (int t = tid; t < tc; t += kThreads)
            H[(doc0 + d) * T + t0 + t] = 0.f;
        }
      }
      if (live == 0) continue;  // uniform: no doc of the block in the pass
    }
    // 2. the first two chunks in flight, then the query rows of the pass.
    Cursor cur{0, 0};
    cur.skip_dead(live, nd);
    Cursor ahead = cur;
    for (int k = 0; k < 2; ++k) {
      stage(ahead, buf + k * buf_bytes);
      if (ahead.d < nd) ahead.next(cnt_s, live, nd);
    }
    stage_f32(q_s, o.ts, q_b + (int64_t)t0 * M, M, tc, kPassT, tid);
    const float* q_r = q_s + (size_t)(16 * qh + qg) * o.ts;

    float run[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) run[c] = COLBANDIT_NEG;
    // The doc whose maxima wait in red for the next barrier, or -1.
    int pending = -1;
    auto flush = [&]() {
      for (int t = tid; t < tc; t += kThreads) {  // t == lane: tc <= 32
        float v = red[t];
        for (int h = 1; h < kHalves; ++h) v = nan_max(v, red[h * kPassT + t]);
        if constexpr (kTiles) v = (on >> pending) & 1u ? v : 0.f;
        H[(doc0 + pending) * T + t0 + t] = v;
      }
      pending = -1;
    };
    // 3. chunk k computes while chunk k + 1 lands.
    for (int k = 0; cur.d < nd; ++k) {
      copy_async_wait<1>();  // this thread's chunk k has landed
      __syncthreads();       // everyone's has; q_s, sc_s, red are written
      if (pending >= 0) flush();
      const int n_k = min(kChunk, cnt_s[cur.d] - cur.c * kChunk);
      unsigned char* raw = buf + (k & 1) * buf_bytes;
      const float* e_s = reinterpret_cast<const float*>(raw);
      if constexpr (!kDirect) {
        dequant_chunk<Rows, kCbGlobal>(
            raw, tile, tok_s + cur.d * L + cur.c * kChunk, sc_s + cur.d * L,
            cd_s + cur.d * L, cb, n_k, M, o.rs, o.ts, o.cbs, tid);
        __syncthreads();  // the tile is written and raw is free
        stage(ahead, raw);
        if (ahead.d < nd) ahead.next(cnt_s, live, nd);
        e_s = tile;
      }
      // Warp-uniform: the query half has rows (masked: an active tile).
      bool half_on = 16 * qh < tc;
      if constexpr (kTiles) half_on = (halves >> (2 * cur.d + qh)) & 1u;
      if (half_on) {
        const int groups = (n_k + 7) / 8;
        dot_rows((groups - tb + kHalves - 1) / kHalves, e_s, q_r, o.ts, M, tg,
                 tb, n_k, run);
      }
      if constexpr (kDirect) {
        __syncthreads();  // chunk k's buffer is free
        stage(ahead, raw);
        if (ahead.d < nd) ahead.next(cnt_s, live, nd);
      }
      const int d = cur.d;
      const bool last = cur.last_of_doc(cnt_s);
      cur.next(cnt_s, live, nd);
      if (last) {  // 4. the doc's maxima meet
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = run[c];
#pragma unroll
          for (int off = 1; off < 8; off <<= 1)
            x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, off));
          if (tg == 0) red[tb * kPassT + 16 * qh + qg + 4 * c] = x;
          run[c] = COLBANDIT_NEG;
        }
        pending = d;
      }
    }
    __syncthreads();  // red is written; q_s and the buffers are free
    if (pending >= 0) flush();
  }
}

// The kernels' names start with maxsim_kernel<DenseRows or <QuantRows and
// masked_maxsim<DenseRows or <QuantRows, which is what chip_smoke.py's
// profiles look for. Both take the same arguments; maxsim_kernel ignores
// the tile mask. kCbGlobal: the layout leaves the codebook in global memory
// (layout().cb_staged false).
template <typename Rows, typename TQ, int kDocs, bool kCbGlobal>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
maxsim_kernel(Rows rows, const uint8_t* __restrict__ mask,
              const TQ* __restrict__ Qb, float* __restrict__ H, int N, int L,
              int M, int T, int Kc, int gran, TileMask) {
  maxsim_body<Rows, TQ, false, kDocs, kCbGlobal>(rows, mask, Qb, H, N, L, M,
                                                 T, Kc, gran, TileMask{});
}

template <typename Rows, typename TQ, bool kCbGlobal>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
masked_maxsim(Rows rows, const uint8_t* __restrict__ mask,
              const TQ* __restrict__ Qb, float* __restrict__ H, int N, int L,
              int M, int T, int Kc, int gran, TileMask tiles) {
  maxsim_body<Rows, TQ, true, kMaskedDocs, kCbGlobal>(rows, mask, Qb, H, N, L,
                                                      M, T, Kc, gran, tiles);
}

}  // namespace dense

struct Args {
  const uint8_t* mask;
  const void* Q;
  float* H;
  int B, N, L, M, T;
  TileMask tiles;  // tiles.m == nullptr: the dense kernel
  int docs;        // docs per block (block_n)
  cudaStream_t stream;
};

template <int kDocs, bool kCbGlobal, typename Rows, typename TQ>
int launch_kernel(const Rows& rows, const Args& a, int kc, size_t smem) {
  using Elem = typename Rows::Elem;
  auto kernel = a.tiles.m ? &dense::masked_maxsim<Rows, TQ, kCbGlobal>
                          : &dense::maxsim_kernel<Rows, TQ, kDocs, kCbGlobal>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.N + kDocs - 1) / kDocs, a.B);
  kernel<<<grid, dense::kThreads, smem, a.stream>>>(
      rows, a.mask, static_cast<const TQ*>(a.Q), a.H, a.N, a.L, a.M, a.T, kc,
      copy_granularity(rows.raw(0), a.M * (int)sizeof(Elem)), a.tiles);
  return (int)cudaGetLastError();
}

// The kernel the layout asks for: the codebook staged or left in global
// memory, the one decision of dense::layout() that the size query reports
// too.
template <int kDocs, typename Rows, typename TQ>
int launch_docs(const Rows& rows, const Args& a) {
  using Elem = typename Rows::Elem;
  const int kc = codebook_rows(rows);
  const dense::Layout o =
      dense::layout(a.L, a.M, sizeof(Elem), Rows::kScaled, kc, kDocs);
  if constexpr (Rows::kCodebook) {
    if (!o.cb_staged)
      return launch_kernel<kDocs, true, Rows, TQ>(rows, a, kc, o.total);
  }
  return launch_kernel<kDocs, false, Rows, TQ>(rows, a, kc, o.total);
}

// The masked kernel is built for kMaskedDocs alone; the dense one for each
// block_n of dense_docs_ok.
template <typename Rows, typename TQ>
int launch(const Rows& rows, const Args& a) {
  if (a.tiles.m) {
    if (a.docs != dense::kMaskedDocs) return (int)cudaErrorInvalidValue;
    return launch_docs<dense::kMaskedDocs, Rows, TQ>(rows, a);
  }
  switch (a.docs) {
    case 1: return launch_docs<1, Rows, TQ>(rows, a);
    case 2: return launch_docs<2, Rows, TQ>(rows, a);
    case 4: return launch_docs<4, Rows, TQ>(rows, a);
    default: return (int)cudaErrorInvalidValue;
  }
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
                int L, int M, int T, int block_n, void* stream) {
  return Args{mask, Q, H, B, N, L, M, T, TileMask{nullptr, 1, 1, 0}, block_n,
              static_cast<cudaStream_t>(stream)};
}

// One query (B = 1); tile_mask is (ceil(N/bn), ceil(T/bt)) bool.
Args masked_args(const uint8_t* mask, const void* Q, const uint8_t* tile_mask,
                 float* H, int N, int L, int M, int T, int bn, int bt,
                 void* stream) {
  return Args{mask, Q, H, 1, N, L, M, T,
              TileMask{tile_mask, bn, bt, (T + bt - 1) / bt},
              dense::kMaskedDocs, static_cast<cudaStream_t>(stream)};
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

// Bytes of shared memory one block of a dense entry point launched at
// block_n docs per block takes (the masked ones: block_n = 2) for docs of L
// tokens of M elements of elem_bytes bytes (4 f32, 2 bf16, 1 int8), scaled
// rows (the _q entry points) and Kc codebook rows (0 without one): the
// launch's own dense::layout(), with the codebook staged only where it
// fits; -1 where block_n is not one the dense kernel is built for.
extern "C" long long colbandit_maxsim_smem_bytes(int L, int M, int elem_bytes,
                                                 int scaled, int Kc,
                                                 int block_n) {
  if (!dense::dense_docs_ok(block_n)) return -1;
  return (long long)dense::layout(L, M, elem_bytes, scaled != 0, Kc, block_n)
      .total;
}

extern "C" int colbandit_maxsim(const void* E, const uint8_t* mask,
                                const void* Q, float* H, int B, int N, int L,
                                int M, int T, int e_bf16, int q_bf16,
                                int block_n, void* stream) {
  return dense_corpus(E,
                      dense_args(mask, Q, H, B, N, L, M, T, block_n, stream),
                      e_bf16, q_bf16);
}

// codes and codebook are nullptr for the int8 format (Kc ignored); the
// codebook is shared by every (b, i).
extern "C" int colbandit_maxsim_q(const int8_t* data, const void* scales,
                                  const int32_t* codes, const float* codebook,
                                  int Kc, const uint8_t* mask, const void* Q,
                                  float* H, int B, int N, int L, int M, int T,
                                  int s_bf16, int q_bf16, int block_n,
                                  void* stream) {
  return quant_corpus(data, scales, codes, codebook, Kc,
                      dense_args(mask, Q, H, B, N, L, M, T, block_n, stream),
                      s_bf16, q_bf16);
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
