#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # one CUDA card; exits non-zero on any failure

Phases, in order:
  1. device: the card's name and power limit (``nvidia-smi``);
  2. build: ``nvcc`` compiles the kernels from ``src/repro_torch/kernels/csrc``;
  3. kernels: each CUDA kernel against its plain PyTorch version on the card,
     at the serving path's shapes plus edge cases, with timings and bounds;
  4. main path: ``serve_queries`` dense and bandit (fused and chain round
     bodies) over a 65,536-doc corpus at the text config's widths (T=32,
     L=128, M=128), with launch counts, cross-checks, throughput and a
     profiled call per flavor (device busy time, top kernels).

The last two lines of standard output are the device line and
``{"ok": true, "device": {...}}``; the line before them lists every kernel as
JSON. TF32 is switched off for matrix products and cuDNN, so every float32
reference product runs in full float32.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
RTOL, ATOL = 1e-5, 1e-6   # f32 and bf16 inputs alike: both upcast exactly
SEED = 0
CORPUS = dict(n_docs=65536, doc_len=128, min_doc_len=32, query_len=32,
              dim=128, n_queries=16)
MAX_CANDIDATES = 256
K = 5
NEG = float(np.float32(-3e38))   # the all-masked sentinel as float32


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def peaks(name: str):
    """(bytes/s, f32 FLOP/s) of the card variant, from NVIDIA's data sheets."""
    if "PCIe" in name:
        return 2.0e12, 51e12
    if "NVL" in name:
        return 3.9e12, 60e12
    return 3.35e12, 67e12          # H100 SXM


def cuda_ms(fn, reps: int = 7, inner: int = 20) -> float:
    """Median per-call device time over ``reps`` runs of ``inner`` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    both = torch.isfinite(got) & torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), torch.isfinite(want)):
        return float("inf")
    return float((got[both] - want[both]).abs().max()) if both.any() else 0.0


def check_close(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        fail(f"{label}: max |kernel - plain| = {max_err(got, want)} beyond "
             f"rtol={RTOL}, atol={ATOL}")
    return max_err(got, want)


def corpus_like(gen, D, L, M, dtype, min_len, dead=()):
    """Unit-norm doc tokens with prefix masks of random length >= min_len;
    docs listed in ``dead`` are all-masked."""
    e = torch.randn((D, L, M), generator=gen, device="cuda")
    e = e / e.norm(dim=-1, keepdim=True)
    lens = torch.randint(min_len, L + 1, (D,), generator=gen, device="cuda")
    mask = torch.arange(L, device="cuda")[None, :] < lens[:, None]
    for d in dead:
        mask[d] = False
    return e.to(dtype).contiguous(), mask.contiguous()


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import BanditConfig
    from repro_torch.core.bandit import stable_topk
    from repro_torch.core.metrics import overlap_at_k
    from repro_torch.data.synthetic import make_retrieval_dataset
    from repro_torch.kernels import _build
    from repro_torch.kernels.gather_maxsim import gather_maxsim_cuda, \
        gather_maxsim_plain
    from repro_torch.kernels.maxsim import maxsim_batch_cuda, \
        maxsim_batch_plain
    from repro_torch.kernels.reveal import fused_reveal_cuda, \
        fused_reveal_plain
    from repro_torch.retrieval.index import from_numpy
    from repro_torch.retrieval.pipeline import candidates_for, serve_queries
    from repro_torch.retrieval.service import gather_candidates

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device --------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    bw, f32_peak = peaks(name)
    print(f"device: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | peaks {bw / 1e12} TB/s, "
          f"{f32_peak / 1e12} f32 TFLOP/s", flush=True)

    # 2. build ---------------------------------------------------------------
    secs = _build.build()
    print(f"build: {secs:.1f} s ({', '.join(_build.SOURCES)})", flush=True)
    for src, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")

    # 3. kernels against their plain versions ---------------------------------
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    records = {}

    def bound(nbytes, flops):
        t_b, t_f = nbytes / bw * 1e3, flops / f32_peak * 1e3
        return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")

    # maxsim: edge cases, then the dense path's shape (B=16, N=256).
    cases = [("slice", 16, 256, 128, 32, 128, torch.float32),
             ("bf16", 16, 256, 128, 32, 128, torch.bfloat16),
             ("odd", 3, 5, 77, 19, 100, torch.float32),
             ("two-passes", 2, 7, 40, 45, 64, torch.float32)]
    for label, Bq, N, L, T, M, dt in cases:
        e, m = corpus_like(gen, Bq * N, L, M, dt, min(32, L), dead=(1,))
        e, m = e.reshape(Bq, N, L, M), m.reshape(Bq, N, L)
        q = torch.randn((Bq, T, M), generator=gen, device="cuda").to(dt)
        got = maxsim_batch_cuda(e, m, q)
        err = check_close(f"maxsim {label}", got, maxsim_batch_plain(e, m, q))
        if float(got[0, 1].max()) != NEG:
            fail("maxsim: an all-masked doc must give -3e38")
        print(f"kernel maxsim {label} B={Bq} N={N} L={L} T={T} M={M} "
              f"{str(dt)[6:]}: max_abs_err={err:.3g} ok (rtol={RTOL}, "
              f"atol={ATOL})", flush=True)
        if label == "slice":
            valid = int(m.sum())
            nbytes = valid * M * 4 + m.numel() + q.numel() * 4 + got.numel() * 4
            b_ms, b_by = bound(nbytes, 2 * T * M * valid)
            records["maxsim"] = dict(
                name="maxsim", route="cuda",
                source="src/repro_torch/kernels/csrc/maxsim.cu",
                replaces="src/repro/kernels/maxsim.py:87", max_abs_err=err,
                ms=cuda_ms(lambda: maxsim_batch_cuda(e, m, q)),
                plain_ms=cuda_ms(lambda: maxsim_batch_plain(e, m, q),
                                 reps=5, inner=3),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # gather_maxsim / fused_reveal: stacked (B*N, L, M) candidates and
    # (B*T, M) query tokens, frontier rows F with G tokens each.
    D, TQ = 16 * 256, 16 * 32
    reveal_cases = [("round", 128, 8, 128, 128, torch.float32, "random"),
                    ("init", 4096, 1, 128, 128, torch.float32, "random"),
                    ("bf16", 128, 8, 128, 128, torch.bfloat16, "random"),
                    ("F=1", 1, 8, 128, 128, torch.float32, "random"),
                    ("odd", 37, 3, 77, 100, torch.float32, "random"),
                    ("new-none", 128, 8, 128, 128, torch.float32, "none"),
                    ("G=64", 64, 64, 128, 128, torch.float32, "random")]
    for label, F, G, L, M, dt, fresh in reveal_cases:
        e, m = corpus_like(gen, D, L, M, dt, min(32, L), dead=(3, 5))
        qt = torch.randn((TQ, M), generator=gen, device="cuda").to(dt)
        sets = []
        for _ in range(8):   # rotate selections so a launch finds its docs cold
            di = torch.randint(0, D, (F,), generator=gen, device="cuda")
            di[0] = 3                                   # an all-masked doc
            ti = torch.randint(0, TQ, (F, G), generator=gen, device="cuda")
            nm = (torch.rand((F, G), generator=gen, device="cuda") < 0.7
                  if fresh == "random" else
                  torch.zeros((F, G), dtype=torch.bool, device="cuda"))
            sets.append((di, ti, nm))
        di, ti, nm = sets[0]
        got = gather_maxsim_cuda(e, m, qt, di, ti)
        want = gather_maxsim_plain(e, m, qt, di, ti)
        err_g = check_close(f"gather_maxsim {label}", got, want)
        vals, stats = fused_reveal_cuda(e, m, qt, di, ti, nm)
        pv, ps = fused_reveal_plain(e, m, qt, di, ti, nm)
        err_v = check_close(f"fused_reveal {label} vals", vals, pv)
        err_s = check_close(f"fused_reveal {label} stats", stats, ps)
        if not torch.equal(vals, got):
            fail(f"{label}: fused_reveal and gather_maxsim values differ")
        if not torch.equal(stats[:, 0], nm.sum(-1).float()):
            fail(f"{label}: fused_reveal counts differ from new_mask")
        if float(got[0].max()) != NEG:
            fail("gather_maxsim: an all-masked doc must give -3e38")
        print(f"kernel gather_maxsim/fused_reveal {label} F={F} G={G} L={L} "
              f"M={M} {str(dt)[6:]} new={fresh}: max_abs_err vals={err_v:.3g} "
              f"stats={err_s:.3g} gather={err_g:.3g} ok (rtol={RTOL}, "
              f"atol={ATOL}); fused vals == gather vals", flush=True)
        if label not in ("round", "init"):
            continue
        it = [0]

        def nxt():
            it[0] += 1
            return sets[it[0] % len(sets)]

        valid = sum(int(m[s[0]].sum()) for s in sets) / len(sets)
        esz = e.element_size()
        common = valid * M * esz + F * L + F * G * M * 4 + F * 8 + F * G * 8
        for kname, fn, plain, extra in (
                ("gather_maxsim",
                 lambda: gather_maxsim_cuda(e, m, qt, *nxt()[:2]),
                 lambda: gather_maxsim_plain(e, m, qt, *nxt()[:2]),
                 F * G * 4),
                ("fused_reveal",
                 lambda: fused_reveal_cuda(e, m, qt, *nxt()),
                 lambda: fused_reveal_plain(e, m, qt, *nxt()),
                 F * G + F * G * 4 + F * 12)):
            b_ms, b_by = bound(common + extra, 2 * G * M * valid)
            rec = dict(name=kname, route="cuda",
                       source="src/repro_torch/kernels/csrc/reveal.cu",
                       replaces=("src/repro/kernels/gather_maxsim.py:83"
                                 if kname == "gather_maxsim" else
                                 "src/repro/kernels/reveal.py:143"),
                       max_abs_err=max(err_g if kname == "gather_maxsim"
                                       else max(err_v, err_s), 0.0),
                       ms=cuda_ms(fn), plain_ms=cuda_ms(plain, reps=5,
                                                        inner=5),
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
            print(f"timing {kname} {label} F={F} G={G}: "
                  f"{json.dumps(rec)}", flush=True)
            if label == "round":
                records[kname] = rec

    # 4. main path -------------------------------------------------------------
    t0 = time.perf_counter()
    ds = make_retrieval_dataset(**CORPUS, seed=SEED)
    index = from_numpy(ds.doc_embs, ds.doc_mask, ds.doc_lens, device="cuda")
    torch.cuda.synchronize()
    print(f"corpus: {CORPUS} -> {index.doc_embs.numel() * 4 / 1e9:.3f} GB f32 "
          f"resident, built in {time.perf_counter() - t0:.1f} s", flush=True)
    queries = torch.as_tensor(ds.queries, device="cuda")
    nq = queries.shape[0]
    calls = {
        "dense": dict(flavor="dense"),
        "pooled": dict(flavor="bandit", engine="pooled",
                       bandit=BanditConfig(k=K)),
        "pooled_chain": dict(flavor="bandit", engine="pooled_chain",
                             bandit=BanditConfig(k=K)),
    }
    kernel_of = {"dense": "maxsim", "pooled": "fused_reveal",
                 "pooled_chain": "gather_maxsim"}
    out, launches, wall = {}, {}, {}
    for label, kw in calls.items():
        _build.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out[label] = serve_queries(index, queries, k=K,
                                   max_candidates=MAX_CANDIDATES, seed=SEED,
                                   device="cuda", **kw)
        torch.cuda.synchronize()
        first = time.perf_counter() - t
        launches[label] = dict(_build.LAUNCHES)
        runs = []
        for _ in range(3):
            t = time.perf_counter()
            serve_queries(index, queries, k=K, max_candidates=MAX_CANDIDATES,
                          seed=SEED, device="cuda", **kw)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t)
        wall[label] = statistics.median(runs)
        res = out[label]
        print(f"main {label}: launches {launches[label]}; first call "
              f"{first * 1e3:.1f} ms; median of 3 warm calls "
              f"{wall[label] * 1e3:.1f} ms per batch of {nq} = "
              f"{nq / wall[label]:.1f} queries/s; mean reveal_fraction "
              f"{res.reveal_fraction.mean():.4f}; stats {res.stats.tolist()}",
              flush=True)
        if launches[label][kernel_of[label]] == 0:
            fail(f"{label}: the {kernel_of[label]} kernel was never launched")
        if res.topk_ids.shape != (nq, K) or not np.isfinite(
                res.topk_scores[res.topk_ids >= 0]).all():
            fail(f"{label}: malformed result {res.topk_ids.shape}")

    t = time.perf_counter()
    cand = candidates_for(index.doc_embs, index.doc_mask, queries, kprime=10,
                          max_candidates=MAX_CANDIDATES, support=(0.0, 1.0))
    torch.cuda.synchronize()
    stage1 = time.perf_counter() - t
    print(f"stage 1 alone: {stage1 * 1e3:.1f} ms per batch; candidates per "
          f"query {cand.doc_mask.sum(1).tolist()}", flush=True)

    # Where the time goes: one profiled call per flavor and one of stage 1.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    profiled = dict(calls, stage1=None)
    for label, kw in profiled.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if kw is None:
                candidates_for(index.doc_embs, index.doc_mask, queries,
                               kprime=10, max_candidates=MAX_CANDIDATES,
                               support=(0.0, 1.0))
            else:
                serve_queries(index, queries, k=K,
                              max_candidates=MAX_CANDIDATES, seed=SEED,
                              device="cuda", **kw)
            torch.cuda.synchronize()
        # Device-side records only (kernels, copies, sets); CPU ops also
        # carry their kernels' time and would count it twice.
        avg = prof.key_averages()
        ev = [e for e in avg if e.device_type == DeviceType.CUDA
              and e.key != "Command Buffer Full"
              and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in ev) / 1e3
        ref_ms = (stage1 if kw is None else wall[label]) * 1e3
        stalls = sum(e.count for e in avg if e.key == "Command Buffer Full")
        top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
        print(f"profile {label}: device busy {busy:.2f} ms in "
              f"{sum(e.count for e in ev)} device ops, against {ref_ms:.1f} ms "
              f"of unprofiled wall time (idle share {1 - busy / ref_ms:.3f}); "
              f"{stalls} launch stalls on a full command buffer; top: "
              + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f}"
                          f" ms x{e.count}" for e in top), flush=True)

    # Dense top-5 equals an exhaustive plain-version top-5 wherever the
    # 5th/6th score gap exceeds 1e-4.
    docs, dmask = gather_candidates(index.doc_embs, index.doc_mask,
                                    cand.doc_ids)
    h = maxsim_batch_plain(docs, dmask, queries)
    h = torch.where(dmask.any(2)[:, :, None], h, 0.0)
    scores = torch.where(cand.doc_ids >= 0, h.sum(-1), -3e38)
    top_v, top_i = stable_topk(scores, K + 1)
    plain_ids = torch.gather(cand.doc_ids, 1, top_i[:, :K]).cpu().numpy()
    gaps = (top_v[:, K - 1] - top_v[:, K]).cpu().numpy()
    checked = 0
    for qi in range(nq):
        if gaps[qi] > 1e-4:
            checked += 1
            if set(out["dense"].topk_ids[qi]) != set(plain_ids[qi]):
                fail(f"dense top-{K} of query {qi} differs from the "
                     "exhaustive plain top-K")
    print(f"check dense == exhaustive plain top-{K}: {checked}/{nq} queries "
          "with a 5th/6th gap > 1e-4 agree", flush=True)

    fused, chain = out["pooled"], out["pooled_chain"]
    if not (np.array_equal(fused.topk_ids, chain.topk_ids)
            and np.array_equal(fused.reveal_fraction, chain.reveal_fraction)):
        fail("fused and chain round bodies disagree")
    overlap = overlap_at_k(torch.as_tensor(fused.topk_ids),
                           torch.as_tensor(out["dense"].topk_ids))
    mean_overlap = float(overlap.mean())
    mean_frac = float(fused.reveal_fraction.mean())
    print(f"check chain == fused: identical topk_ids and reveal_fraction; "
          f"bandit overlap@{K} with dense {mean_overlap:.4f} (>= 0.9); mean "
          f"reveal_fraction {mean_frac:.4f} (< 1)", flush=True)
    if mean_overlap < 0.9:
        fail(f"overlap@{K} {mean_overlap} < 0.9")
    if not mean_frac < 1.0:
        fail(f"mean reveal_fraction {mean_frac} is not below 1")

    for label, kname in kernel_of.items():
        records[kname]["launches"] = launches[label][kname]
    order = ("fused_reveal", "maxsim", "gather_maxsim")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: records[n][k] for k in keys}
                                  for n in order]}))
    print(f"device: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
