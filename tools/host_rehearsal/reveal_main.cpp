// Host rehearsal program (run.sh): every reveal entry point of reveal.cu on
// small shapes, held bit for bit to a direct reference that computes each
// cell as the dense maxsim kernel does (one sequential fma chain over m,
// nan-propagating max over the valid tokens) and the statistics in
// reveal_stats' order. Covers docs longer than a chunk, masks with holes,
// rows that are not 16-byte aligned (copied in 4-, 2- and 1-byte pieces),
// bf16 rows and queries, int8 and residual rows with clamped codes and
// indices, G = 0, 1 and 64, G = 96 and 128 (two chunks of query rows, the
// statistics carried across them), residual codebooks too large to stage
// (Kc = 600 at M = 128 and 2,000 at M = 33: read from global memory, each
// launch under 227 KB), and every case at both block shapes (block_l
// 64 and 32, each launch's shared memory equal to the size query's), with
// launches small and large enough for either to be the default.
#include <algorithm>
#include <cstdio>
#include <random>
#include <vector>

#include "src/reveal.cpp"  // the prepared copy of reveal.cu (run.sh)

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
  int D, L, M, F, G, TQ;
  Kind kind;
  int Kc;
  bool holes;  // valid tokens a random subset, not a prefix
};

int run(const Case& c) {
  const int D = c.D, L = c.L, M = c.M, F = c.F, G = c.G, TQ = c.TQ;
  const bool quant = c.kind >= kInt8F32Scales;
  std::vector<uint8_t> mask(D * L);
  for (int d = 0; d < D; ++d) {
    const int len = 1 + rng() % L;
    for (int l = 0; l < L; ++l)
      mask[d * L + l] = c.holes ? (rng() % 3 != 0) : (l < len);
  }
  std::fill(mask.begin() + 3 * L, mask.begin() + 4 * L, 0);  // doc 3: empty
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
  std::vector<float> Q(TQ * M);
  std::vector<__nv_bfloat16> Qb(TQ * M);
  for (int i = 0; i < TQ * M; ++i) {
    Qb[i] = to_bf16(urand());
    Q[i] = c.kind == kBf16 ? __bfloat162float(Qb[i]) : urand();
  }
  std::vector<int64_t> di(F), ti(F * G);
  for (auto& x : di) x = int64_t(rng() % (D + 2)) - 1;  // -1 and D clamp
  if (F > 0) di[0] = 3;
  for (auto& x : ti) x = int64_t(rng() % (TQ + 2)) - 1;
  std::vector<uint8_t> nm(F * G);
  for (auto& x : nm) x = rng() % 2;

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
  std::vector<float> want(F * G), wstats(F * 3);
  for (int f = 0; f < F; ++f) {
    const int64_t d = std::clamp<int64_t>(di[f], 0, D - 1);
    float cnt = 0, tot = 0, sq = 0;
    for (int g = 0; g < G; ++g) {
      const int64_t t = std::clamp<int64_t>(ti[f * G + g], 0, TQ - 1);
      float run = -3e38f;
      for (int l = 0; l < L; ++l) {
        if (!mask[d * L + l]) continue;
        float acc = 0.f;
        for (int m = 0; m < M; ++m)
          acc = std::fma(elem(d * L + l, m), Q[t * M + m], acc);
        run = (acc > run || acc != acc) ? acc : run;
      }
      want[f * G + g] = run;
      const bool fresh = nm[f * G + g];
      const float vm = fresh ? run : 0.f;
      cnt += fresh ? 1.f : 0.f;
      tot += vm;
      sq += vm * run;
    }
    wstats[f * 3] = cnt;
    wstats[f * 3 + 1] = tot;
    wstats[f * 3 + 2] = sq;
  }

  const int esz = c.kind == kF32 ? 4 : c.kind == kBf16 ? 2 : 1;
  int bad = 0;
  long long smem_wide = 0;  // the two shapes stage different buffers
  for (const int block_l : {64, 32}) {
    g_smem_max = 0;
    std::vector<float> gv(F * G, 7.f), fv(F * G, 7.f), st(F * 3, 7.f);
    const int q_bf16 = c.kind == kBf16;
    const void* Qp = q_bf16 ? (const void*)Qb.data() : (const void*)Q.data();
    int rc;
    if (!quant) {
      const void* E = c.kind == kF32 ? (const void*)Ef.data()
                                     : (const void*)Eb.data();
      rc = colbandit_gather_maxsim(E, mask.data(), Qp, di.data(), ti.data(),
                                   gv.data(), F, G, L, M, D, TQ, q_bf16,
                                   q_bf16, block_l, nullptr);
      rc |= colbandit_fused_reveal(E, mask.data(), Qp, di.data(), ti.data(),
                                   nm.data(), fv.data(), st.data(), F, G, L, M,
                                   D, TQ, q_bf16, q_bf16, block_l, nullptr);
    } else {
      const int s_bf16 = c.kind != kInt8F32Scales;
      const void* scales = s_bf16 ? (const void*)scb.data()
                                  : (const void*)sc.data();
      const int32_t* cd = c.kind == kResidual ? codes.data() : nullptr;
      const float* cbp = c.kind == kResidual ? cb.data() : nullptr;
      rc = colbandit_gather_maxsim_q(dp, scales, cd, cbp, c.Kc, mask.data(),
                                     Qp, di.data(), ti.data(), gv.data(), F, G,
                                     L, M, D, TQ, s_bf16, 0, block_l, nullptr);
      rc |= colbandit_fused_reveal_q(dp, scales, cd, cbp, c.Kc, mask.data(),
                                     Qp, di.data(), ti.data(), nm.data(),
                                     fv.data(), st.data(), F, G, L, M, D, TQ,
                                     s_bf16, 0, block_l, nullptr);
    }
    bad += rc != 0;
    for (int i = 0; i < F * G; ++i)
      if (std::memcmp(&gv[i], &want[i], 4) ||
          std::memcmp(&fv[i], &want[i], 4)) {
        if (bad < 5)
          printf("  cell %d: %.9g %.9g want %.9g\n", i, gv[i], fv[i], want[i]);
        ++bad;
      }
    for (int i = 0; i < F * 3; ++i)
      if (std::memcmp(&st[i], &wstats[i], 4)) {
        if (bad < 5) printf("  stat %d: %g want %g\n", i, st[i], wstats[i]);
        ++bad;
      }
    const long long smem = colbandit_reveal_smem_bytes(
        F, G, L, M, esz, quant, c.kind == kResidual ? c.Kc : 0, block_l);
    // G = 0 launches nothing; otherwise the launch took what the query says.
    bad += G > 0 && smem != (long long)g_smem_max;
    bad += smem > (long long)kSharedMemBytes;
    if (block_l == 64) smem_wide = smem;
    else bad += smem == smem_wide;
    const bool cb_global =
        c.kind == kResidual &&
        !by_shape(block_l, [&](auto shape) {
          return layout<decltype(shape)>(G, L, M, esz, quant, c.Kc).cb_staged;
        });
    g_cb_global += cb_global && block_l == 64;
    const bool is_default =
        block_l == (F > 512 ? 32 : 64) &&
        smem == colbandit_reveal_smem_bytes(F, G, L, M, esz, quant,
                                            c.kind == kResidual ? c.Kc : 0, 0);
    printf("%-24s D=%d L=%d M=%d F=%d G=%d block_l=%d%s: %s%s (smem %lld, "
           "launched %zu, barriers %lld, cp.async copies of 16/8/4 bytes: "
           "%lld/%lld/%lld)\n",
           c.name, D, L, M, F, G, block_l, is_default ? " (default)" : "",
           bad ? "FAIL" : "bit-equal",
           cb_global ? ", codebook in global memory" : "", smem, g_smem_max,
           g_barriers,
           g_async_copies[16], g_async_copies[8], g_async_copies[4]);
    g_smem_max = 0;
    g_barriers = 0;
    std::memset(g_async_copies, 0, sizeof(g_async_copies));
  }
  return bad;
}

}  // namespace

int main() {
  const Case cases[] = {
      {"f32 round", 40, 128, 128, 8, 8, 32, kF32, 0, false},
      {"f32 L=200 holes", 12, 200, 64, 5, 8, 32, kF32, 0, true},
      {"bf16 M=77", 12, 77, 77, 5, 3, 16, kBf16, 0, false},
      {"f32 M=33 L=300", 6, 300, 33, 4, 1, 8, kF32, 0, true},
      {"int8 f32 scales G=64", 12, 77, 100, 3, 64, 80, kInt8F32Scales, 0,
       false},
      {"int8 M=33", 12, 130, 33, 4, 5, 16, kInt8Bf16Scales, 0, true},
      {"residual Kc=8", 12, 128, 128, 6, 8, 32, kResidual, 8, true},
      {"residual Kc=1 M=100", 12, 77, 100, 4, 3, 16, kResidual, 1, false},
      {"init G=1", 16, 128, 128, 16, 1, 32, kF32, 0, false},
      {"narrow F=600 G=2", 40, 70, 64, 600, 2, 32, kF32, 0, true},
      {"narrow F=520 G=1", 40, 128, 128, 520, 1, 32, kF32, 0, false},
      {"narrow residual G=1", 40, 128, 128, 530, 1, 32, kResidual, 8, true},
      {"narrow int8 G=8", 40, 100, 100, 520, 8, 32, kInt8F32Scales, 0,
       true},
      {"G=0", 8, 16, 32, 2, 0, 8, kF32, 0, false},
      {"f32 G=96 holes", 12, 150, 64, 3, 96, 128, kF32, 0, true},
      {"bf16 G=128", 12, 77, 77, 2, 128, 128, kBf16, 0, false},
      {"int8 G=96", 12, 100, 100, 3, 96, 128, kInt8Bf16Scales, 0, true},
      {"residual Kc=600 G=8", 12, 128, 128, 4, 8, 32, kResidual, 600, true},
      {"residual Kc=600 G=128", 12, 128, 128, 2, 128, 128, kResidual, 600,
       false},
      {"residual Kc=2000 M=33", 12, 70, 33, 3, 5, 16, kResidual, 2000, true},
      {"narrow residual Kc=600", 40, 64, 128, 520, 1, 32, kResidual, 600,
       false},
  };
  int bad = 0;
  for (const Case& c : cases) bad += run(c) != 0;
  // Any G >= 0 has a size: G = 65 and 200 take G = 64's layout (one chunk
  // of query rows at a time).
  const long long g64 = colbandit_reveal_smem_bytes(8, 64, 128, 128, 4, 0,
                                                    0, 0);
  const long long g65 = colbandit_reveal_smem_bytes(8, 65, 128, 128, 4, 0,
                                                    0, 0);
  const long long g200 = colbandit_reveal_smem_bytes(8, 200, 128, 128, 4, 0,
                                                     0, 0);
  const long long neg = colbandit_reveal_smem_bytes(8, -1, 128, 128, 4, 0, 0,
                                                    0);
  const long long no_shape = colbandit_reveal_smem_bytes(8, 8, 128, 128, 4,
                                                         0, 0, 48);
  printf("G=65, 200: smem bytes %lld, %lld (want G=64's %lld); G=-1: %lld "
         "(want -1); block_l=48: %lld (want -2)\n", g65, g200, g64, neg,
         no_shape);
  bad += g65 != g64 || g200 != g64;
  bad += neg != -1;
  bad += no_shape != -2;
  // The staged codebook ends near Kc = 390 for an int8 round launch.
  printf("codebook in global memory in %d cases (want 4)\n", g_cb_global);
  bad += g_cb_global != 4;
  printf(bad ? "REHEARSAL FAILED\n" : "rehearsal ok\n");
  return bad != 0;
}
