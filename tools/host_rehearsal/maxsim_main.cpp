// Host rehearsal program (run.sh): the dense entry points of maxsim.cu on
// small shapes at every docs-per-block they are built for (block_n 1, 2
// and 4, each launch's shared memory equal to the size query's), every
// cell held bit for bit to a direct reference (one
// sequential fma chain over m from 0, nan-propagating max over the valid
// tokens, -3e38 for an all-masked doc), and the masked entry points held to
// where(tile, reference, 0) in every case, under a random tile mask and a
// patterned one. Covers f32 and bf16 rows and queries, int8 rows with f32
// and bf16 scales, residual rows with Kc = 8 and 1 and clamped codes, and
// with codebooks too large to stage (Kc = 400 at M = 128, Kc = 2,000 at
// M = 33: read from global memory, each launch under 227 KB), rows
// that are not 16-byte aligned (M = 100 int8 rows in 4-byte pieces, M = 33
// in single bytes), M not a multiple of 4, docs across chunk edges, masks
// with holes, an all-masked doc in every case, N not a multiple of the docs
// per block, and T = 40 and 64 (two passes). The tile grids: bn = 1, 2, 3,
// 4 and 5 (with bn odd the two docs of a block straddle tile rows), bt = 3,
// 8, 16, 20, 32 and 40 (tiles that span both passes); the patterned mask
// cycles its tile rows through all inactive (a block with no active tile),
// first column only, last column only (a pass with no active tile at T =
// 40 and 64, one 16-row query half at T = 32) and all active.
#include <algorithm>
#include <cstdio>
#include <random>
#include <vector>

#include "src/maxsim.cpp"  // the prepared copy of maxsim.cu (run.sh)

namespace {

std::mt19937 rng(0);
int g_cb_global = 0;  // cases whose codebook the layout left in global memory
float urand() { return std::uniform_real_distribution<float>(-1, 1)(rng); }
__nv_bfloat16 to_bf16(float x) {
  uint32_t u;
  std::memcpy(&u, &x, 4);
  return {uint16_t(u >> 16)};
}

enum Kind { kF32, kBf16, kInt8F32Scales, kInt8Bf16Scales, kResidual };

struct Case {
  const char* name;
  int B, N, L, T, M;
  Kind kind;
  int Kc;
  bool holes;       // valid tokens a random subset, not a prefix
  int bn, bt;       // the masked launches' tile grid (query 0's docs)
};

int run(const Case& c) {
  const int B = c.B, N = c.N, L = c.L, T = c.T, M = c.M, D = B * N;
  const bool quant = c.kind >= kInt8F32Scales;
  std::vector<uint8_t> mask(D * L);
  for (int d = 0; d < D; ++d) {
    // Lengths around the 64-token chunk edge, and 1 and L.
    const int lens[] = {1, 63, 64, 65, 128, L};
    const int len = std::min(L, d < 6 ? lens[d] : 1 + int(rng() % L));
    for (int l = 0; l < L; ++l)
      mask[d * L + l] = c.holes ? (rng() % 3 != 0) : (l < len);
  }
  std::fill(mask.begin() + 1 * L, mask.begin() + 2 * L, 0);  // doc 1: empty
  std::vector<float> Ef(D * L * M);
  for (auto& x : Ef) x = urand();
  std::vector<__nv_bfloat16> Eb(Ef.size());
  for (size_t i = 0; i < Ef.size(); ++i) Eb[i] = to_bf16(Ef[i]);
  // An odd M starts the int8 payload one byte in: rows byte-aligned only.
  std::vector<int8_t> data(Ef.size() + 16);
  int8_t* dp = data.data() + (M % 2 ? 1 : 0);
  for (size_t i = 0; i < Ef.size(); ++i) dp[i] = int(rng() % 255) - 127;
  std::vector<float> sc(D * L);
  std::vector<__nv_bfloat16> scb(D * L);
  std::vector<int32_t> codes(D * L);
  for (int i = 0; i < D * L; ++i) {
    scb[i] = to_bf16(urand() * 0.01f);
    sc[i] = __bfloat162float(scb[i]);  // the same scales in either type
    codes[i] = int(rng() % (c.Kc + 2)) - 1;  // -1 and Kc are clamped
  }
  std::vector<float> cb(std::max(c.Kc, 1) * M);
  for (auto& x : cb) x = urand();
  std::vector<float> Q(B * T * M);
  std::vector<__nv_bfloat16> Qb(Q.size());
  for (size_t i = 0; i < Q.size(); ++i) {
    Qb[i] = to_bf16(urand());
    Q[i] = c.kind == kBf16 ? __bfloat162float(Qb[i]) : urand();
  }

  auto elem = [&](int64_t r, int m) -> float {
    switch (c.kind) {
      case kF32: return Ef[r * M + m];
      case kBf16: return __bfloat162float(Eb[r * M + m]);
      case kInt8F32Scales:
      case kInt8Bf16Scales: return __fmul_rn((float)dp[r * M + m], sc[r]);
      default: {
        const int k = std::clamp(codes[r], 0, c.Kc - 1);
        return __fadd_rn(__fmul_rn((float)dp[r * M + m], sc[r]),
                         cb[k * M + m]);
      }
    }
  };
  std::vector<float> want(D * T);
  for (int d = 0; d < D; ++d) {
    const int b = d / N;
    for (int t = 0; t < T; ++t) {
      float run = -3e38f;
      for (int l = 0; l < L; ++l) {
        if (!mask[d * L + l]) continue;
        float acc = 0.f;
        for (int m = 0; m < M; ++m)
          acc = std::fma(elem((int64_t)d * L + l, m),
                         Q[((int64_t)b * T + t) * M + m], acc);
        run = (acc > run || acc != acc) ? acc : run;
      }
      want[d * T + t] = run;
    }
  }

  const int q_bf16 = c.kind == kBf16;
  const void* Qp = q_bf16 ? (const void*)Qb.data() : (const void*)Q.data();
  const int s_bf16 = c.kind != kInt8F32Scales;
  const void* scales = s_bf16 ? (const void*)scb.data()
                              : (const void*)sc.data();
  const int32_t* cd = c.kind == kResidual ? codes.data() : nullptr;
  const float* cbp = c.kind == kResidual ? cb.data() : nullptr;
  const void* E = c.kind == kF32 ? (const void*)Ef.data()
                                 : (const void*)Eb.data();
  // The dense entry points at every docs-per-block the kernel is built for
  // (block_n 1, 2, 4): each cell bit-equal, each launch's shared memory
  // equal to the query's for its block_n.
  const int esz = c.kind == kF32 ? 4 : c.kind == kBf16 ? 2 : 1;
  int bad = 0;
  long long smem = 0, barriers = 0;
  size_t launched = 0;
  bool cb_global = false;  // the layout left the codebook in global memory
  for (const int block_n : {1, 2, 4}) {
    std::vector<float> got(D * T, 7.f);
    g_smem_max = 0;
    const int rc =
        quant ? colbandit_maxsim_q(dp, scales, cd, cbp, c.Kc, mask.data(), Qp,
                                   got.data(), B, N, L, M, T, s_bf16, 0,
                                   block_n, nullptr)
              : colbandit_maxsim(E, mask.data(), Qp, got.data(), B, N, L, M, T,
                                 q_bf16, q_bf16, block_n, nullptr);
    int bad_n = rc != 0;
    for (int i = 0; i < D * T; ++i)
      if (std::memcmp(&got[i], &want[i], 4)) {
        if (bad_n < 5)
          printf("  block_n %d cell %d: %.9g want %.9g\n", block_n, i, got[i],
                 want[i]);
        ++bad_n;
      }
    const long long q = colbandit_maxsim_smem_bytes(
        L, M, esz, quant, c.kind == kResidual ? c.Kc : 0, block_n);
    bad_n += q != (long long)g_smem_max;
    bad_n += q > (long long)kSharedMemBytes;
    if (c.kind == kResidual)
      cb_global = !dense::layout(L, M, esz, quant, c.Kc, block_n).cb_staged;
    if (bad_n) printf("  block_n %d: FAIL (smem %lld, launched %zu)\n",
                      block_n, q, g_smem_max);
    bad += bad_n;
    if (block_n == 2) {  // the masked kernel's docs per block
      smem = q;
      launched = g_smem_max;
      barriers = g_barriers;
    }
  }
  bad += colbandit_maxsim_smem_bytes(L, M, esz, quant, 0, 3) != -1;
  int rc = 0;
  g_smem_max = 0;

  // The masked entry point on query 0's N docs, under a random tile mask
  // (density 0.4, tile row 0 all active: doc 1, all-masked, gives -3e38)
  // and the patterned one; every cell == where(tile, reference, 0).
  const int bn = c.bn, bt = c.bt, gi = (N + bn - 1) / bn;
  const int gj = (T + bt - 1) / bt;
  int masked_bad = 0;
  for (int pattern = 0; pattern < 2; ++pattern) {
    std::vector<uint8_t> tiles(gi * gj);
    for (int r = 0; r < gi; ++r)
      for (int j = 0; j < gj; ++j) {
        const int kind = r % 4;
        tiles[r * gj + j] = pattern == 0 ? (r == 0 || rng() % 5 < 2)
                            : kind == 0  ? 0
                            : kind == 1  ? j == 0
                            : kind == 2  ? j == gj - 1
                                         : 1;
      }
    std::vector<float> mg(N * T, 7.f);
    rc = quant ? colbandit_masked_maxsim_q(dp, scales, cd, cbp, c.Kc,
                                           mask.data(), Qp, tiles.data(),
                                           mg.data(), N, L, M, T, bn, bt,
                                           s_bf16, 0, nullptr)
               : colbandit_masked_maxsim(E, mask.data(), Qp, tiles.data(),
                                         mg.data(), N, L, M, T, bn, bt,
                                         q_bf16, q_bf16, nullptr);
    masked_bad += rc != 0 || g_smem_max != launched;
    for (int i = 0; i < N; ++i)
      for (int t = 0; t < T; ++t) {
        const float w = tiles[(i / bn) * gj + t / bt] ? want[i * T + t] : 0.f;
        if (std::memcmp(&mg[i * T + t], &w, 4)) ++masked_bad;
      }
  }
  g_cb_global += cb_global;
  printf("%-28s B=%d N=%d L=%d T=%d M=%d: %s at block_n 1/2/4; bn=%d bt=%d "
         "%s%s (block_n 2: smem %lld, "
         "launched %zu, barriers %lld, cp.async copies of 16/8/4 bytes: "
         "%lld/%lld/%lld)\n",
         c.name, B, N, L, T, M, bad ? "FAIL" : "bit-equal", bn, bt,
         masked_bad ? "masked FAIL" : "masked == where(tile, ref, 0)",
         cb_global ? "; codebook in global memory" : "", smem,
         launched, barriers, g_async_copies[16], g_async_copies[8],
         g_async_copies[4]);
  g_smem_max = 0;
  g_barriers = 0;
  std::memset(g_async_copies, 0, sizeof(g_async_copies));
  return bad + masked_bad;
}

}  // namespace

int main() {
  const Case cases[] = {
      {"f32 serving widths", 2, 5, 128, 32, 128, kF32, 0, false, 3, 8},
      {"f32 L=200 holes T=40", 1, 7, 200, 40, 64, kF32, 0, true, 1, 20},
      {"f32 T=64 M=32", 1, 6, 130, 64, 32, kF32, 0, false, 4, 40},
      {"bf16 M=77 T=19", 2, 3, 77, 19, 77, kBf16, 0, false, 2, 8},
      {"int8 f32 scales M=100 T=40", 1, 6, 100, 40, 100, kInt8F32Scales, 0,
       false, 3, 32},
      {"int8 bf16 scales M=33", 1, 6, 70, 8, 33, kInt8Bf16Scales, 0, true, 5,
       3},
      {"residual Kc=8", 2, 3, 128, 32, 128, kResidual, 8, true, 1, 16},
      {"residual Kc=1 M=100", 1, 6, 77, 45, 100, kResidual, 1, false, 3, 40},
      {"residual Kc=400 (global)", 2, 3, 128, 32, 128, kResidual, 400, true,
       1, 16},
      {"residual Kc=2000 M=33", 1, 5, 70, 40, 33, kResidual, 2000, false, 3,
       8},
  };
  int bad = 0;
  for (const Case& c : cases) bad += run(c) != 0;
  // Kc = 312 is the last staged codebook at L = M = 128, 2 docs a block.
  const bool edge = dense::layout(128, 128, 1, true, 312, 2).cb_staged &&
                    !dense::layout(128, 128, 1, true, 313, 2).cb_staged;
  printf("codebook in global memory in %d cases (want 2); staged up to "
         "Kc=312 at L=M=128: %s\n", g_cb_global, edge ? "yes" : "NO");
  bad += g_cb_global != 2 || !edge;
  printf(bad ? "MAXSIM REHEARSAL FAILED\n" : "maxsim rehearsal ok\n");
  return bad != 0;
}
