#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # one CUDA card; exits non-zero on any failure

Phases, in order:
  1. device: the card's name and power limit (``nvidia-smi``);
  2. build: ``nvcc`` compiles the kernels from ``src/repro_torch/kernels/csrc``
     (ptxas registers and spills per instantiation; a spill in ``maxsim.cu``
     fails the run);
  3. kernels: each CUDA kernel against its plain PyTorch version on the card,
     at the serving path's shapes plus edge cases, with timings and bounds;
     Each kernel with a compressed-corpus (``_q``) entry point is also run on
     int8 and residual corpora and held to its float32 twin on the
     dequantized corpus bit for bit; every reveal cell is held to the dense
     ``maxsim`` kernel's cell bit for bit, and each dense cell to the same
     doc launched alone; the reveal entry points' round and init launches
     and the dense ``maxsim`` / ``maxsim_q`` launches at the serving shape
     are timed on the device alone (profiler records, L2 flushed before
     each launch), the reveal wrappers also for their host cost alone;
  4. main path: ``serve_queries`` dense and bandit (fused and chain round
     bodies) over a 65,536-doc corpus at the text config's widths (T=32,
     L=128, M=128), with launch counts, cross-checks, throughput and a
     profiled call per flavor (device busy time, top kernels);
  5. compressed serving: ``build_corpus`` encodes the same corpus as f32,
     int8 and residual (8 centroids); ``make_serving_step`` dense and
     bandit (fused and chain) rerank phase 4's stage-1 candidates on each,
     with launch counts, resident bytes per doc, rerank-step times, a
     profiled call per step and the fidelity checks;
  6. tile-masked scoring: (a) ``masked_maxsim_op`` on each query's
     candidate slab of phase 4 (256 docs, a seeded tile mask at density
     0.4), checked against the plain version; (b) one bulk launch over the
     resident 65,536-doc f32, int8 and residual corpora against query 0 at
     tile densities 0, 0.1, 0.4 and 1, timed beside the dense kernel
     (whose device time and bound are printed too);
  7. continuous batching: 48 requests (phase 4's 16 queries, each under 3
     seeds) streamed through 16 slots by ``make_streaming_step``
     (``trip_limit=4``, retired slots refilled), on the f32 and the int8
     corpus: every request equals one-shot ``rerank_bandit_step`` (ids,
     reveal fraction, rounds), a stream alternating fused and chain slices
     reveals the same cells, requests/s against one-shot batches, overlap@5
     with dense; the fidelity knobs (``alpha_scale=1.0`` == no knob bit for
     bit; the ``DegradeLadder``'s 4 levels) and one ``engine="vmapped"``
     call;
  8. research harness: ``evaluate_dataset`` on phase 4's index for exact,
     bandit (with and without ``prereveal_ann``), batched, uniform and
     topmargin over the first HARNESS_QUERIES queries; each H the
     ``maxsim`` kernel computed is held to ``maxsim_plain``, and each
     query's top-K ids and coverage to a second run with the plain H;
  9. serving engine: ``RetrievalEngine`` (f32 and int8),
     ``AsyncRetrievalEngine`` batch and continuous mode and a supervised
     dispatch kill, on phase 4's corpus, queries and stage-1 candidates,
     each completion held to the serving steps bit for bit, with
     requests/s, latency p50/p99 and a profile of each mode (see
     ``serving_engine``).

The last two lines of standard output are the device line and
``{"ok": true, "device": {...}}``; the line before them lists every kernel as
JSON. TF32 is switched off for matrix products and cuDNN, so every float32
reference product runs in full float32.
"""
import contextlib
import dataclasses
import functools
import json
import re
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
STREAM_SEEDS = 3        # phase 7: each query under this many seeds
TRIP_LIMIT = 4          # phase 7: trips per streaming slice
HARNESS_QUERIES = 2     # phase 8: queries per method (cut to fit ~60 s)
NEG = float(np.float32(-3e38))   # the all-masked sentinel as float32
PAD = 512                        # spin kernels that open every profile


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


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call: ``calls`` calls with no synchronisation
    in between, so the device never holds the host back."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


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


def demangle(name: str) -> str:
    """A kernel's C++ name (``c++filt`` where the toolchain has it)."""
    try:
        return subprocess.run(["c++filt", name], capture_output=True,
                              text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return name


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


def unit_rows(gen, shape):
    """Unit-norm random rows, as served query tokens are: every cell then
    has sum_m |e_m q_m| <= 1, so a summation order moves it by ~1e-8."""
    x = torch.randn(shape, generator=gen, device="cuda")
    return x / x.norm(dim=-1, keepdim=True)


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


def serving_engine(dev, index, ds, cand, records, profiled_line, smi, t_start):
    """9. The serving engine on phase 4's corpus, queries and stage-1
    candidates, at the text config's widths (T = 32, L = M = 128), with
    ``EngineConfig(batch_size=16, token_buckets=(32,), cand_buckets=(64,
    256), flavor="auto", bandit_min_candidates=256, stage1_candidates=256,
    stage1_kprime=10, seed=0)``, ``max_k=K`` as phase 4's bandit, and a
    30 s admission window so that only full batches release and the sync
    and async engines batch alike. 48 requests: each query with its 256
    stage-1 candidates (bandit), with their first 64 (dense), and
    candidate-less (engine stage 1).

    (a) sync ``RetrievalEngine`` on the f32 corpus (48 requests) and an
        int8 one (the 32 candidate-carrying requests): warmed buckets only,
        every completion equal to the serving step on the same padded
        inputs with the engine's batch seeds bit for bit, engine stage 1
        equal to phase 4's ``candidates_for``, and the engine's launches
        equal to the steps' alone;
    (b) ``AsyncRetrievalEngine`` batch mode (pipeline depth 2) on the same
        stream: every completion equal to (a)'s bit for bit;
    (c) continuous mode on f32 (48 requests) and int8 (32): every rid
        equal to the one-shot bandit step on its slot seed
        ``fold_in(key(0), rid)`` in batches of 16 rows (the stream's slot
        count, so reductions see the same shapes);
    (d) supervision: a dispatch thread killed once and restarted (zero
        lost, zero duplicated, completions equal to (b)'s), and an
        unsupervised kill that ``drain()`` raises.

    Returns the kernels' launches in the served runs (not the checks)."""
    import collections

    from repro_torch.core.draws import TorchDraws
    from repro_torch.kernels import _build
    from repro_torch.retrieval.service import make_serving_step
    from repro_torch.serve import (AsyncRetrievalEngine, EngineConfig,
                                   FaultPlan, InjectedFault, Request,
                                   RetrievalEngine, pad_candidates,
                                   support_bounds)

    nq, T, _ = ds.queries.shape
    cfg = EngineConfig(batch_size=nq, deadline_s=30.0, token_buckets=(T,),
                       cand_buckets=(64, MAX_CANDIDATES), max_k=K,
                       flavor="auto", bandit_min_candidates=MAX_CANDIDATES,
                       stage1_candidates=MAX_CANDIDATES, stage1_kprime=10,
                       seed=SEED)
    ids = [r[r >= 0] for r in cand.doc_ids.cpu().numpy()]
    requests = ([Request(query=ds.queries[i], k=K, cand_ids=ids[i])
                 for i in range(nq)]
                + [Request(query=ds.queries[i], k=K, cand_ids=ids[i][:64])
                   for i in range(nq)]
                + [Request(query=ds.queries[i], k=K) for i in range(nq)])
    served = collections.Counter()
    draws = TorchDraws()
    base = draws.key(SEED, dev)
    queries = torch.as_tensor(ds.queries, device=dev)

    def sync_dev():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(eng, reqs, started, tally=True):
        """Serve ``reqs`` through a warmed engine; completions by rid,
        seconds, and the launches of the run (added to the phase's count
        unless ``tally`` is False)."""
        _build.reset_launches()
        sync_dev()
        t = time.perf_counter()
        if started:
            with eng:
                for r in reqs:
                    eng.submit(r)
                done = eng.drain()
        else:
            for r in reqs:
                eng.submit(r)
            done = eng.drain()
        sync_dev()
        secs = time.perf_counter() - t
        counts = {k: v for k, v in _build.LAUNCHES.items() if v}
        if tally:
            served.update(counts)
        got = {c.rid: c for c in done}
        if not len(got) == len(done) == len(reqs):
            fail(f"phase 9: {len(done)} completions, {len(got)} rids for "
                 f"{len(reqs)} requests")
        if eng.metrics.compiles_after_warmup:
            fail(f"phase 9: {eng.metrics.compiles_after_warmup} builds "
                 "after warmup")
        return got, secs, counts

    def line(label, eng, got, secs, counts):
        s = eng.metrics.summary()
        frac = np.mean([c.reveal_fraction for c in got.values()])
        print(f"phase 9 {label}: {len(got)} requests in {secs * 1e3:.1f} ms "
              f"= {len(got) / secs:.1f} requests/s; latency p50 "
              f"{s['latency_p50_ms']:.1f} ms, p99 {s['latency_p99_ms']:.1f} "
              f"ms; mean reveal fraction {frac:.4f} per request, "
              f"{s['mean_reveal_fraction']:.4f} per batch or slice "
              f"({s['n_batches']}); "
              f"compiles_after_warmup {s['compiles_after_warmup']}; "
              f"launches {counts}; {smi}", flush=True)
        return s

    def same(got, want, label):
        bad = [r for r in want if not (
            np.array_equal(got[r].topk_ids, want[r].topk_ids)
            and np.array_equal(got[r].topk_scores, want[r].topk_scores)
            and got[r].reveal_fraction == want[r].reveal_fraction)]
        if sorted(got) != sorted(want) or bad:
            fail(f"phase 9 {label}: rids {bad} differ")

    def padded(reqs, nb):
        """The engine's (16, nb) inputs of candidate-carrying requests."""
        c = pad_candidates([r.cand_ids for r in reqs], nb)
        a, b = support_bounds(c, [T] * len(reqs), T, cfg.support)
        return tuple(torch.as_tensor(x, device=dev) for x in (c, a, b))

    # (a) sync engine == steps --------------------------------------------
    sync = {}
    for fmt, reqs in (("f32", requests), ("int8", requests[:2 * nq])):
        t = time.perf_counter()
        eng = RetrievalEngine(index.doc_embs, index.doc_mask,
                              dataclasses.replace(cfg, corpus_format=(
                                  "bf16" if fmt == "f32" else fmt)),
                              device=dev)
        warm = eng.warmup()
        sync_dev()
        print(f"phase 9a {fmt}: engine built and warmed in "
              f"{time.perf_counter() - t:.1f} s, buckets {warm} "
              f"(builds {dict(eng.metrics.compiles)})", flush=True)
        got, secs, counts = run(eng, reqs, started=False)
        s = line(f"(a) sync {fmt}", eng, got, secs, counts)
        _build.reset_launches()
        for ordinal in range(len(reqs) // nq):
            batch = reqs[ordinal * nq:(ordinal + 1) * nq]
            if batch[0].cand_ids is None:
                s1 = eng._stage1(T, ds.queries)
                if not all(np.array_equal(x, y.cpu().numpy()) for x, y in
                           zip(s1, (cand.doc_ids, cand.a, cand.b))):
                    fail("phase 9a: engine stage 1 differs from "
                         "candidates_for")
                args = (cand.doc_ids, cand.a, cand.b)
            else:
                args = padded(batch, eng.buckets.cand_bucket(
                    max(len(r.cand_ids) for r in batch)))
            flavor = eng.flavor_for(args[0].shape[1])
            seeds = draws.split(draws.fold_in(base, ordinal), nq)
            want = make_serving_step(flavor, topk=K)(
                eng.corpus_embs, eng.corpus_mask, queries, *args, seeds,
                alpha_scale=1.0, round_cap=0)
            scores, gids, frac, _ = (x.cpu().numpy() for x in want)
            for i in range(nq):
                c = got[ordinal * nq + i]
                if not (c.flavor == flavor
                        and np.array_equal(c.topk_ids, gids[i])
                        and np.array_equal(c.topk_scores, scores[i])
                        and c.reveal_fraction == float(frac[i])):
                    fail(f"phase 9a {fmt}: rid {c.rid} differs from "
                         f"make_serving_step({flavor!r})")
        steps = {k: v for k, v in _build.LAUNCHES.items() if v}
        q_ = "_q" if fmt == "int8" else ""
        if counts != steps or not (counts.get("fused_reveal" + q_)
                                   and counts.get("maxsim" + q_)):
            fail(f"phase 9a {fmt}: engine launches {counts}, steps alone "
                 f"{steps}")
        print(f"phase 9a {fmt}: every completion == make_serving_step on "
              "the same padded inputs and batch seeds, bit for bit"
              + ("; engine stage 1 == candidates_for" if fmt == "f32"
                 else "") + f"; launches == the steps' alone {steps}",
              flush=True)
        sync[fmt] = (eng, got, secs, s)
    eng_a, got_a, secs_a, _ = sync["f32"]
    print(profiled_line("phase 9a sync f32", lambda: run(
        eng_a, requests, False, tally=False), secs_a * 1e3), flush=True)

    # (b) async batch mode == sync ----------------------------------------
    eng_b = AsyncRetrievalEngine(index.doc_embs, index.doc_mask,
                                 dataclasses.replace(cfg, pipeline_depth=2),
                                 device=dev)
    eng_b.warmup()
    got_b, secs_b, counts = run(eng_b, requests, started=True)
    line("(b) async batch, pipeline_depth 2", eng_b, got_b, secs_b, counts)
    same(got_b, got_a, "(b) async")
    print(f"phase 9b: every completion == (a)'s bit for bit; requests/s "
          f"async / sync {secs_a / secs_b:.3f}", flush=True)
    print(profiled_line("phase 9b async", lambda: run(
        eng_b, requests, True, tally=False), secs_b * 1e3), flush=True)

    # (c) continuous mode == one-shot per rid -------------------------------
    def stream_rows(reqs, nb):
        """The stream's (len(reqs), nb) inputs: stage-1 requests take
        phase 4's candidate rows (their query's), the others are padded."""
        rows = []
        for i, r in enumerate(reqs):
            if r.cand_ids is None:
                qi = int(np.flatnonzero([x is r for x in requests])[0]) % nq
                rows.append((cand.doc_ids[qi], cand.a[qi], cand.b[qi]))
            else:
                rows.append(tuple(x[0] for x in padded([r], nb)))
        return [torch.stack(x) for x in zip(*rows)]

    for fmt, reqs in (("f32", requests), ("int8", requests[:2 * nq])):
        eng = AsyncRetrievalEngine(
            index.doc_embs, index.doc_mask, dataclasses.replace(
                cfg, continuous=True,
                corpus_format="bf16" if fmt == "f32" else fmt), device=dev)
        eng.warmup()
        got, secs, counts = run(eng, reqs, started=True)
        line(f"(c) continuous {fmt}, {nq} slots, trip_limit "
             f"{cfg.stream_trip_limit}", eng, got, secs, counts)
        q_ = "_q" if fmt == "int8" else ""
        if not counts.get("fused_reveal" + q_):
            fail(f"phase 9c {fmt}: launches {counts}")
        nb = eng._stream_bucket[1]
        bad = []
        for g0 in range(0, len(reqs), nq):      # rid = position in reqs
            group = reqs[g0:g0 + nq]
            seeds = torch.stack([draws.fold_in(base, g0 + j)
                                 for j in range(len(group))])
            one = make_serving_step("bandit", topk=K)(
                eng.corpus_embs, eng.corpus_mask,
                queries[[(g0 + j) % nq for j in range(len(group))]],
                *stream_rows(group, nb), seeds)
            _, gids, frac, _ = (x.cpu().numpy() for x in one)
            bad += [g0 + j for j in range(len(group)) if not (
                np.array_equal(got[g0 + j].topk_ids, gids[j])
                and got[g0 + j].reveal_fraction == float(frac[j]))]
        if bad:
            fail(f"phase 9c {fmt}: rids {bad} differ from the one-shot "
                 "bandit step on their slot seeds")
        print(f"phase 9c {fmt}: every rid == one-shot make_serving_step("
              "'bandit') on seed fold_in(key(0), rid) (ids, reveal "
              f"fraction); requests/s continuous / sync "
              f"{sync[fmt][2] / secs:.3f}", flush=True)
        if fmt == "f32":
            eng_c = eng
            print(profiled_line("phase 9c continuous f32", lambda: run(
                eng, reqs, True, tally=False), secs * 1e3), flush=True)

    # The three modes' wall times again, in turns (host-bound runs spread).
    walls = {"sync": [], "async": [], "continuous": []}
    modes = {"sync": (eng_a, False), "async": (eng_b, True),
             "continuous": (eng_c, True)}
    for mode in ("sync", "async", "continuous", "continuous", "async",
                 "sync"):
        eng, started = modes[mode]
        walls[mode].append(run(eng, requests, started, tally=False)[1])
    med = {m: statistics.median(w) for m, w in walls.items()}
    n = len(requests)
    print("phase 9 in turns (sync, async, continuous, continuous, async, "
          f"sync), ms for {len(requests)} requests: " + "; ".join(
              f"{m} {[round(x * 1e3, 1) for x in w]}"
              for m, w in walls.items())
          + f"; requests/s by median: sync {n / med['sync']:.1f}, async "
          f"{n / med['async']:.1f} ({med['sync'] / med['async']:.3f}x), "
          f"continuous {n / med['continuous']:.1f} "
          f"({med['sync'] / med['continuous']:.3f}x); {smi}", flush=True)

    # (d) supervision -------------------------------------------------------
    plan = FaultPlan([InjectedFault("dispatch", 2, "kill")])
    eng = AsyncRetrievalEngine(index.doc_embs, index.doc_mask,
                               dataclasses.replace(cfg, supervise=True),
                               device=dev, fault_plan=plan)
    eng.warmup()
    _build.reset_launches()
    for r in requests:                 # queued before the threads start
        eng.submit(r)
    t = time.perf_counter()
    eng.start()
    done = eng.drain()
    eng.stop()
    secs = time.perf_counter() - t
    served.update({k: v for k, v in _build.LAUNCHES.items() if v})
    rids = [c.rid for c in done]
    s = eng.metrics.summary()
    lost = len(set(range(len(requests))) - set(rids))
    dup = len(rids) - len(set(rids))
    print(f"phase 9d supervised: dispatch killed at tick 2 "
          f"(fired {[f.action for f in plan.fired]}); restarts "
          f"{s['thread_restarts']}; {len(done)} completions in "
          f"{secs * 1e3:.1f} ms; lost {lost}, duplicated {dup}, errors "
          f"{s['errors']}", flush=True)
    if (lost or dup or s["errors"]
            or s["thread_restarts"] != {"repro-dispatch": 1}
            or [f.action for f in plan.fired] != ["kill"]):
        fail("phase 9d: the supervised kill lost, duplicated or failed "
             "requests, or did not restart once")
    same({c.rid: c for c in done}, got_b, "(d) supervised")
    eng = AsyncRetrievalEngine(
        index.doc_embs, index.doc_mask, cfg, device=dev,
        fault_plan=FaultPlan([InjectedFault("dispatch", 1, "kill")]))
    eng.warmup()
    for r in requests[:nq]:
        eng.submit(r)
    eng.start()
    try:
        eng.drain()
        fail("phase 9d: an unsupervised kill did not make drain() raise")
    except RuntimeError as e:
        if "serving thread died" not in str(e):
            raise
    eng.stop()
    flushed = eng.poll()
    if sorted(c.rid for c in flushed) != list(range(nq)) or any(
            c.error for c in flushed):
        fail("phase 9d: stop() after an unsupervised kill did not serve "
             "every request")
    print(f"phase 9d unsupervised: drain() raised 'serving thread died'; "
          f"stop() served all {nq} queued requests; (d) supervised == (b) "
          "bit for bit", flush=True)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
    return served


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import BanditConfig
    from repro_torch.core.bandit import stable_topk
    from repro_torch.core.metrics import overlap_at_k
    from repro_torch.data.synthetic import make_retrieval_dataset
    from repro_torch.kernels import _build
    from repro_torch.kernels.masked_maxsim import masked_maxsim_cuda, \
        masked_maxsim_plain, masked_maxsim_q_cuda
    from repro_torch.kernels.ops import masked_maxsim_op
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core.frontier import _REV_THRESH
    from repro_torch.kernels.gather_maxsim import gather_maxsim_cuda, \
        gather_maxsim_plain, gather_maxsim_q_cuda
    from repro_torch.kernels.maxsim import maxsim_batch_cuda, \
        maxsim_batch_plain, maxsim_batch_q_cuda
    from repro_torch.kernels.quant import corpus_index, corpus_nbytes, \
        corpus_reshape, dequantize, quantize
    from repro_torch.kernels.reveal import fused_reveal_cuda, \
        fused_reveal_plain, fused_reveal_q_cuda
    from repro_torch.retrieval.corpus import build_corpus
    from repro_torch.retrieval.index import from_numpy
    from repro_torch.kernels.maxsim import maxsim_plain
    from repro_torch.retrieval import pipeline
    from repro_torch.retrieval.pipeline import candidates_for, \
        evaluate_dataset, serve_queries
    from repro_torch.retrieval.service import gather_candidates, \
        init_stream_state, make_serving_step, make_streaming_step, \
        rerank_bandit_step
    from repro_torch.serve.resilience import DegradeLadder

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
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

    print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
    # 2. build ---------------------------------------------------------------
    secs = _build.build()
    print(f"build: {secs:.1f} s ({', '.join(_build.SOURCES)})", flush=True)
    spilled = []
    for src, log in _build.BUILD_LOG.items():
        # ptxas -v: "Function properties for <name>", then the stack/spill
        # line, then "Used N registers"; one line per kernel instantiation.
        fn, spill = "?", ""
        for line in log.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                print(f"  ptxas {src}: {demangle(fn)}: {spill}; "
                      f"{line.split(':', 1)[-1].strip()}")
                n = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", spill)
                if src == "maxsim.cu" and (n is None or int(n[1])
                                           or int(n[2])):
                    spilled.append(demangle(fn))
    if spilled:
        fail(f"ptxas: maxsim.cu instantiations spill: {spilled}")
    if "maxsim.cu" not in _build.BUILD_LOG:
        print("  ptxas maxsim.cu: not built in this process (a cached "
              "library), so its spills are not checked", flush=True)

    print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
    # 3. kernels against their plain versions ---------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    records = {}

    @contextlib.contextmanager
    def pad_profile():
        """A profile whose first device records are a host pause and PAD
        spin kernels: in a long-lived process a profile drops its first
        device records, more with every profile taken, and these take that
        loss."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(PAD):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            yield prof
            torch.cuda.synchronize()

    # Twice the 50 MB L2: zeroing it before a launch leaves its docs cold.
    l2_flush = torch.empty(2 ** 25, device="cuda")

    def device_ms(fn, body, n=20):
        """Device ms per launch of the kernel whose name contains ``body``,
        from the profiler's records of n launches of ``fn`` with L2 flushed
        before each: no host cost, cold docs. Fails unless every launch has
        its record."""
        with pad_profile() as prof:
            for _ in range(n):
                l2_flush.zero_()
                fn()
        recs = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and body in e.key]
        if sum(e.count for e in recs) != n:
            fail(f"device_ms: {sum(e.count for e in recs)} records of {body} "
                 f"for {n} launches")
        return sum(e.self_device_time_total for e in recs) / 1e3 / n

    def dense_cells(e, m, qtab, di, ti):
        """The dense maxsim kernel's cells (doc di[f], query row ti[f, g]),
        on the same corpus (float or QuantTokens) and query rows."""
        F = di.shape[0]
        md = m[di][None].contiguous()
        if isinstance(e, torch.Tensor):
            h = maxsim_batch_cuda(e[di][None].contiguous(), md, qtab[None])
        else:
            h = maxsim_batch_q_cuda(corpus_reshape(corpus_index(e, di), 1, F),
                                    md, qtab[None])
        return torch.gather(h[0], 1, ti)

    def bound(nbytes, flops):
        t_b, t_f = nbytes / bw * 1e3, flops / f32_peak * 1e3
        return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")

    def reveal_reads(sets, m):
        """Means over the rotated selections of what a reveal launch
        computes on and must read once: valid tokens of the selected docs
        (with repeats, for the flops), and the valid tokens, docs and query
        rows it touches (each distinct one once, for the bytes)."""
        valid = docs = toks = 0
        for di, ti, _ in sets:
            u = torch.unique(di)
            valid += int(m[u].sum())
            docs += u.numel()
            toks += torch.unique(ti).numel()
        n = len(sets)
        flops_valid = sum(int(m[s[0]].sum()) for s in sets) / n
        return flops_valid, valid / n, docs / n, toks / n

    # maxsim: the dense path's shape (B=16, N=256), then edge cases: docs
    # per block not dividing N, ragged lengths and holes across the 64-token
    # chunk edges, query passes of 32 tokens (T = 45, 64).
    cases = [("slice", 16, 256, 128, 32, 128, torch.float32),
             ("bf16", 16, 256, 128, 32, 128, torch.bfloat16),
             ("odd", 3, 5, 77, 19, 100, torch.float32),
             ("two-passes", 2, 7, 40, 45, 64, torch.float32),
             ("holes T=64", 2, 9, 200, 64, 128, torch.float32)]
    for label, Bq, N, L, T, M, dt in cases:
        e, m = corpus_like(gen, Bq * N, L, M, dt, min(32, L), dead=(1,))
        if label.startswith("holes"):
            m = torch.rand((Bq * N, L), generator=gen, device="cuda") < 0.6
            m[1] = False
        e, m = e.reshape(Bq, N, L, M), m.reshape(Bq, N, L).contiguous()
        q = unit_rows(gen, (Bq, T, M)).to(dt)
        got = maxsim_batch_cuda(e, m, q)
        err = check_close(f"maxsim {label}", got, maxsim_batch_plain(e, m, q))
        if float(got[0, 1].max()) != NEG:
            fail("maxsim: an all-masked doc must give -3e38")
        # A cell depends on neither the doc's place in the launch nor the
        # docs beside it: each doc alone in a batch of its own.
        alone = maxsim_batch_cuda(e.reshape(Bq * N, 1, L, M),
                                  m.reshape(Bq * N, 1, L),
                                  q.repeat_interleave(N, 0))
        if not torch.equal(alone.reshape(got.shape), got):
            fail(f"maxsim {label}: a cell moved with the launch's shape")
        print(f"kernel maxsim {label} B={Bq} N={N} L={L} T={T} M={M} "
              f"{str(dt)[6:]}: max_abs_err={err:.3g} ok (rtol={RTOL}, "
              f"atol={ATOL}); == one doc per batch bit for bit", flush=True)
        if label == "slice":
            valid = int(m.sum())
            nbytes = valid * M * 4 + m.numel() + q.numel() * 4 + got.numel() * 4
            b_ms, b_by = bound(nbytes, 2 * T * M * valid)
            fn = functools.partial(maxsim_batch_cuda, e, m, q)
            records["maxsim"] = dict(
                name="maxsim", route="cuda",
                source="src/repro_torch/kernels/csrc/maxsim.cu",
                replaces="src/repro/kernels/maxsim.py:87", max_abs_err=err,
                ms=cuda_ms(fn),
                plain_ms=cuda_ms(lambda: maxsim_batch_plain(e, m, q),
                                 reps=5, inner=3),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                device_ms=device_ms(fn, "maxsim_kernel<DenseRows"))
            print(f"timing maxsim slice: {json.dumps(records['maxsim'])}",
                  flush=True)

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
        qt = unit_rows(gen, (TQ, M)).to(dt)
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
        if not torch.equal(got, dense_cells(e, m, qt, di, ti)):
            fail(f"{label}: reveal cells differ from the dense maxsim "
                 "kernel's cells")
        if not torch.equal(stats[:, 0], nm.sum(-1).float()):
            fail(f"{label}: fused_reveal counts differ from new_mask")
        if float(got[0].max()) != NEG:
            fail("gather_maxsim: an all-masked doc must give -3e38")
        print(f"kernel gather_maxsim/fused_reveal {label} F={F} G={G} L={L} "
              f"M={M} {str(dt)[6:]} new={fresh}: max_abs_err vals={err_v:.3g} "
              f"stats={err_s:.3g} gather={err_g:.3g} ok (rtol={RTOL}, "
              f"atol={ATOL}); fused vals == gather vals == maxsim cells",
              flush=True)
        if label not in ("round", "init"):
            continue
        it = [0]

        def nxt():
            it[0] += 1
            return sets[it[0] % len(sets)]

        valid, valid_u, docs_u, toks_u = reveal_reads(sets, m)
        esz = e.element_size()
        common = (valid_u * M * esz + docs_u * L + toks_u * M * esz + F * 8
                  + F * G * 8)
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
                       bound_ms=b_ms, bound_by=b_by, library_ms=None,
                       device_ms=device_ms(fn, "reveal_kernel<DenseRows"),
                       host_us=host_us(fn))
            print(f"timing {kname} {label} F={F} G={G}: "
                  f"{json.dumps(rec)}", flush=True)
            if label == "round":
                records[kname] = rec

    # 3b. the _q kernels on compressed corpora: against the plain version
    # (same tolerance) and against the f32 kernel on the dequantized corpus
    # (bit for bit). The JSON line carries the int8 timings; residual ones
    # are printed beside them.
    def quant_like(D, L, M, fmt, Kc, dead):
        """A corpus_like corpus encoded as ``fmt``, with an all-zero token
        row to encode (scale 0) in doc 2 (for residual: a row on a
        centroid, whose residual is zero) and, for residual, a row coded
        Kc - 1 in doc 4."""
        e, m = corpus_like(gen, D, L, M, torch.float32, min(32, L), dead)
        e[2, 0] = 0.0
        cb = None
        if fmt == "residual":
            cb = unit_rows(gen, (Kc, M))
            e[2, 0] = cb[0]
            e[4, 0] = 2.0 * cb[Kc - 1]
        qt = quantize(e, fmt, codebook=cb)
        if float(qt.scales[2, 0]) != 0.0 or (
                fmt == "residual" and int(qt.codes[4, 0]) != Kc - 1):
            fail(f"{fmt}: the edge rows were not encoded as intended")
        return qt, m

    def quant_bytes(qt, valid, M):
        """Bytes of ``valid`` compressed token rows plus the codebook."""
        row = M + qt.scales.element_size() + (4 if qt.codes is not None
                                              else 0)
        cb = 0 if qt.codebook is None else qt.codebook.numel() * 4
        return valid * row + cb

    def dequant_ops(qt, valid, M):
        return valid * M * (2 if qt.codes is not None else 1)

    q_formats = [("int8", 0), ("residual", 8), ("residual", 1)]
    maxsim_q_cases = [("slice", 16, 256, 128, 32, 128),
                      ("odd", 3, 5, 77, 45, 100),
                      ("holes T=64", 2, 9, 200, 64, 100)]
    for fmt, Kc in q_formats:
        for label, Bq, N, L, T, M in maxsim_q_cases:
            qt, m = quant_like(Bq * N, L, M, fmt, Kc, dead=(1,))
            if label.startswith("holes"):
                m = torch.rand((Bq * N, L), generator=gen, device="cuda") < 0.6
                m[1] = False
            qt, m = corpus_reshape(qt, Bq, N), m.reshape(Bq, N, L).contiguous()
            q = unit_rows(gen, (Bq, T, M))
            got = maxsim_batch_q_cuda(qt, m, q)
            tag = f"maxsim_q {fmt} Kc={Kc} {label}"
            err = check_close(tag, got, maxsim_batch_plain(qt, m, q))
            if not torch.equal(got, maxsim_batch_cuda(dequantize(qt), m, q)):
                fail(f"{tag}: differs from maxsim on the dequantized corpus")
            if float(got[0, 1].max()) != NEG:
                fail(f"{tag}: an all-masked doc must give -3e38")
            print(f"kernel {tag} B={Bq} N={N} L={L} T={T} M={M}: "
                  f"max_abs_err={err:.3g} ok (rtol={RTOL}, atol={ATOL}); "
                  "== maxsim(dequantize) bit for bit", flush=True)
            if label != "slice" or Kc == 1:
                continue
            valid = int(m.sum())
            nbytes = (quant_bytes(qt, valid, M) + m.numel() + q.numel() * 4
                      + got.numel() * 4)
            b_ms, b_by = bound(nbytes, 2 * T * M * valid
                               + dequant_ops(qt, valid, M))
            fn = functools.partial(maxsim_batch_q_cuda, qt, m, q)
            rec = dict(name="maxsim_q", route="cuda",
                       source="src/repro_torch/kernels/csrc/maxsim.cu",
                       replaces="src/repro/kernels/maxsim.py:54",
                       max_abs_err=err, ms=cuda_ms(fn),
                       plain_ms=cuda_ms(lambda: maxsim_batch_plain(qt, m, q),
                                        reps=5, inner=3),
                       bound_ms=b_ms, bound_by=b_by, library_ms=None,
                       device_ms=device_ms(fn, "maxsim_kernel<QuantRows"))
            print(f"timing maxsim_q {fmt} {label}: {json.dumps(rec)}",
                  flush=True)
            if fmt == "int8":
                records["maxsim_q"] = rec

    reveal_q_cases = [("round", 128, 8, 128, 128, "random"),
                      ("init", 4096, 1, 128, 128, "random"),
                      ("F=1", 1, 8, 128, 128, "random"),
                      ("odd", 37, 3, 77, 100, "random"),
                      ("new-none", 128, 8, 128, 128, "none"),
                      ("G=64", 64, 64, 128, 128, "random")]
    for fmt, Kc in q_formats:
        for label, F, G, L, M, fresh in reveal_q_cases:
            if Kc == 1 and label not in ("odd", "round"):
                continue
            qt, m = quant_like(D, L, M, fmt, Kc, dead=(3, 5))
            dense = dequantize(qt)
            qtab = unit_rows(gen, (TQ, M))
            sets = []
            for _ in range(8):
                di = torch.randint(0, D, (F,), generator=gen, device="cuda")
                di[0] = 3                               # an all-masked doc
                ti = torch.randint(0, TQ, (F, G), generator=gen,
                                   device="cuda")
                nm = (torch.rand((F, G), generator=gen, device="cuda") < 0.7
                      if fresh == "random" else
                      torch.zeros((F, G), dtype=torch.bool, device="cuda"))
                sets.append((di, ti, nm))
            di, ti, nm = sets[0]
            tag = f"{fmt} Kc={Kc} {label}"
            got = gather_maxsim_q_cuda(qt, m, qtab, di, ti)
            err_g = check_close(f"gather_maxsim_q {tag}", got,
                                gather_maxsim_plain(qt, m, qtab, di, ti))
            vals, stats = fused_reveal_q_cuda(qt, m, qtab, di, ti, nm)
            pv, ps = fused_reveal_plain(qt, m, qtab, di, ti, nm)
            err_v = check_close(f"fused_reveal_q {tag} vals", vals, pv)
            err_s = check_close(f"fused_reveal_q {tag} stats", stats, ps)
            if not torch.equal(vals, got):
                fail(f"{tag}: fused_reveal_q and gather_maxsim_q differ")
            if not torch.equal(got, dense_cells(qt, m, qtab, di, ti)):
                fail(f"{tag}: reveal cells differ from the dense maxsim_q "
                     "kernel's cells")
            tv, ts = fused_reveal_cuda(dense, m, qtab, di, ti, nm)
            if not (torch.equal(vals, tv) and torch.equal(stats, ts)
                    and torch.equal(got, gather_maxsim_cuda(dense, m, qtab,
                                                            di, ti))):
                fail(f"{tag}: a _q kernel differs from its f32 twin on the "
                     "dequantized corpus")
            if float(got[0].max()) != NEG:
                fail(f"{tag}: an all-masked doc must give -3e38")
            print(f"kernel gather_maxsim_q/fused_reveal_q {tag} F={F} G={G} "
                  f"L={L} M={M} new={fresh}: max_abs_err vals={err_v:.3g} "
                  f"stats={err_s:.3g} gather={err_g:.3g} ok (rtol={RTOL}, "
                  f"atol={ATOL}); fused == gather == f32 twins == maxsim_q "
                  "cells bit for bit", flush=True)
            if label not in ("round", "init") or Kc == 1:
                continue
            it = [0]

            def nxt():
                it[0] += 1
                return sets[it[0] % len(sets)]

            valid, valid_u, docs_u, toks_u = reveal_reads(sets, m)
            common = (quant_bytes(qt, valid_u, M) + docs_u * L
                      + toks_u * M * 4 + F * 8 + F * G * 8)
            ops = 2 * G * M * valid + dequant_ops(qt, valid_u, M)
            for kname, fn, plain, extra in (
                    ("gather_maxsim_q",
                     lambda: gather_maxsim_q_cuda(qt, m, qtab, *nxt()[:2]),
                     lambda: gather_maxsim_plain(qt, m, qtab, *nxt()[:2]),
                     F * G * 4),
                    ("fused_reveal_q",
                     lambda: fused_reveal_q_cuda(qt, m, qtab, *nxt()),
                     lambda: fused_reveal_plain(qt, m, qtab, *nxt()),
                     F * G + F * G * 4 + F * 12)):
                b_ms, b_by = bound(common + extra, ops)
                rec = dict(name=kname, route="cuda",
                           source="src/repro_torch/kernels/csrc/reveal.cu",
                           replaces=("src/repro/kernels/gather_maxsim.py:51"
                                     if kname == "gather_maxsim_q" else
                                     "src/repro/kernels/reveal.py:92"),
                           max_abs_err=(err_g if kname == "gather_maxsim_q"
                                        else max(err_v, err_s)),
                           ms=cuda_ms(fn), plain_ms=cuda_ms(plain, reps=5,
                                                            inner=5),
                           bound_ms=b_ms, bound_by=b_by, library_ms=None,
                           device_ms=device_ms(fn, "reveal_kernel<QuantRows"),
                           host_us=host_us(fn))
                print(f"timing {kname} {fmt} {label} F={F} G={G}: "
                      f"{json.dumps(rec)}", flush=True)
                if label == "round" and fmt == "int8":
                    records[kname] = rec

    # 3c. the tile-masked kernels, in every format: against the plain version
    # (same tolerance) and against where(tile, maxsim twin, 0) bit for bit.
    # Docs 1 and N - 1 are all-masked; the random masks make doc 1's tiles
    # all active (-3e38) and doc N - 1's all inactive (0).
    masked_err = {"masked_maxsim": 0.0, "masked_maxsim_q": 0.0}

    def tile_mask(N, T, bn, bt, density):
        return torch.rand((-(-N // bn), -(-T // bt)), generator=gen,
                          device="cuda") < density

    def tile_full(tm, bn, bt, N, T):
        return tm.repeat_interleave(bn, 0).repeat_interleave(bt, 1)[:N, :T]

    def check_masked(tag, e, m, q, tm, bn, bt, got, twin=None):
        """Hold a masked kernel's output to the plain version and to its
        maxsim twin (recomputed unless given); returns the max error."""
        N, T = got.shape
        kname = ("masked_maxsim" if isinstance(e, torch.Tensor)
                 else "masked_maxsim_q")
        err = check_close(tag, got, masked_maxsim_plain(e, m, q, tm, bn, bt))
        if twin is None:
            twin_fn = (maxsim_batch_cuda if isinstance(e, torch.Tensor)
                       else maxsim_batch_q_cuda)
            twin = twin_fn(corpus_reshape(e, 1, N), m[None], q[None])[0]
        if not torch.equal(got, torch.where(tile_full(tm, bn, bt, N, T),
                                            twin, 0.0)):
            fail(f"{tag}: differs from where(tile, maxsim twin, 0)")
        masked_err[kname] = max(masked_err[kname], err)
        return err

    # bn = 3 puts the two docs of a block in different tile rows; bt = 40
    # spans both 32-row passes of T = 64, so a pass can have no active tile.
    masked_cases = [("slab", 256, 128, 32, 128, 8, 8, "random"),
                    ("odd", 5, 77, 19, 100, 4, 4, "random"),
                    ("none", 256, 128, 32, 128, 8, 8, "none"),
                    ("all", 256, 128, 32, 128, 8, 8, "all"),
                    ("straddle", 7, 77, 32, 100, 3, 8, "random"),
                    ("bt=40 T=64", 9, 100, 64, 128, 3, 40, "random")]
    for fmt, Kc in [("f32", 0), ("bf16", 0)] + q_formats:
        for label, N, L, T, M, bn, bt, tiles in masked_cases:
            dead = (1, N - 1)
            if fmt in ("f32", "bf16"):
                dt = torch.bfloat16 if fmt == "bf16" else torch.float32
                e, m = corpus_like(gen, N, L, M, dt, min(32, L), dead)
                q = unit_rows(gen, (T, M)).to(dt)
                kernel = masked_maxsim_cuda
            else:
                e, m = quant_like(N, L, M, fmt, Kc, dead)
                q = unit_rows(gen, (T, M))
                kernel = masked_maxsim_q_cuda
            tm = tile_mask(N, T, bn, bt, 0.4 if tiles == "random"
                           else float(tiles == "all"))
            if tiles == "random":
                tm[0], tm[(N - 1) // bn] = True, False
            got = kernel(e, m, q, tm, bn, bt)
            tag = f"{kernel.__name__[:-5]} {fmt} Kc={Kc} {label}"
            err = check_masked(tag, e, m, q, tm, bn, bt, got)
            if tiles != "none" and not (got[1] == NEG).all():
                fail(f"{tag}: an all-masked doc in an active tile must give "
                     "-3e38")
            if tiles != "all" and got[N - 1].any():
                fail(f"{tag}: an all-masked doc in an inactive tile must "
                     "give 0")
            if tiles == "none" and got.any():
                fail(f"{tag}: all tiles inactive must give all zeros")
            print(f"kernel {tag} N={N} L={L} T={T} M={M} bn={bn} bt={bt} "
                  f"tiles={tiles} ({int(tm.sum())} of {tm.numel()} active): "
                  f"max_abs_err={err:.3g} ok (rtol={RTOL}, atol={ATOL}); "
                  "== where(tile, maxsim twin, 0) bit for bit", flush=True)

    print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
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
    def profiled_line(label, fn, ref_ms, kernel="", launched=()):
        """Profile one call of ``fn`` and describe its device time against
        ``ref_ms`` of unprofiled wall time. In a long-lived process a
        profile drops its first device records, more with every profile
        taken, so a host pause and PAD spin kernels come first and take
        that loss; they are left out of the sums. A profile counts only if
        some pad record survived (so nothing of ``fn`` was lost at the
        start) and, where ``kernel`` is given, if it holds one record whose
        name contains it per launch that ``fn`` made of the kernels named
        in ``launched``. A profile of ~27,000 device ops has dropped a
        record or two mid-call, so an incomplete one is taken once more;
        the run fails if the second is incomplete too."""
        for attempt in range(2):
            with pad_profile() as prof:
                _build.reset_launches()
                fn()
            n_launched = sum(_build.LAUNCHES[k] for k in launched)
            # Device-side records only (kernels, copies, sets); CPU ops also
            # carry their kernels' time and would count it twice.
            avg = prof.key_averages()
            dev = [e for e in avg if e.device_type == DeviceType.CUDA]
            pad_kept = sum(e.count for e in dev if "spin_kernel" in e.key)
            ev = [e for e in dev if e.key != "Command Buffer Full"
                  and "spin_kernel" not in e.key
                  and e.self_device_time_total > 0]
            n_rec = (sum(e.count for e in ev if kernel in e.key) if kernel
                     else 0)
            why = ("every pad record was lost, so the call's first device "
                   "records may be too" if pad_kept == 0 else
                   f"{n_rec} records of {kernel} for {n_launched} launches"
                   if kernel and n_rec != n_launched else "")
            if not why:
                break
            if attempt:
                fail(f"profile {label}: {why}")
            print(f"profile {label}: {why}; profiling again", flush=True)
        k_ms = sum(e.self_device_time_total for e in ev
                   if kernel and kernel in e.key) / 1e3
        busy = sum(e.self_device_time_total for e in ev) / 1e3
        stalls = sum(e.count for e in avg if e.key == "Command Buffer Full")
        top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
        return (f"profile {label}: device busy {busy:.2f} ms in "
                f"{sum(e.count for e in ev)} device ops, against "
                f"{ref_ms:.1f} ms of unprofiled wall time (idle share "
                f"{1 - busy / ref_ms:.3f}); {stalls} launch stalls on a full "
                f"command buffer; pad records lost {PAD - pad_kept} of {PAD}"
                + (f"; {kernel} records {n_rec} == launches {n_launched}, "
                   f"{k_ms / max(n_rec, 1):.4f} device ms per launch"
                   if kernel else "") + "; top: "
                + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f}"
                            f" ms x{e.count}" for e in top))

    for label, kw in dict(calls, stage1=None).items():
        if kw is None:
            fn = functools.partial(candidates_for, index.doc_embs,
                                   index.doc_mask, queries, kprime=10,
                                   max_candidates=MAX_CANDIDATES,
                                   support=(0.0, 1.0))
        else:
            fn = functools.partial(serve_queries, index, queries, k=K,
                                   max_candidates=MAX_CANDIDATES, seed=SEED,
                                   device="cuda", **kw)
        ref_ms = (stage1 if kw is None else wall[label]) * 1e3
        if kw is None:
            print(profiled_line(label, fn, ref_ms), flush=True)
            continue
        body = "maxsim_kernel" if label == "dense" else "reveal_kernel"
        print(profiled_line(label, fn, ref_ms, f"{body}<DenseRows",
                            (kernel_of[label],)), flush=True)

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

    print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
    # 5. compressed serving ----------------------------------------------------
    # The same corpus resident as f32 ("bf16" passthrough of f32 input), int8
    # and residual (8 centroids, 10 Lloyd iterations, seed 0); every format
    # reranks phase 4's stage-1 candidates through make_serving_step.
    corpora, per_doc = {}, {}
    for label, fmt in (("f32", "bf16"), ("int8", "int8"),
                       ("residual", "residual")):
        t = time.perf_counter()
        corpora[label] = build_corpus(ds.doc_embs, ds.doc_mask,
                                      corpus_format=fmt, device="cuda")
        torch.cuda.synchronize()
        nbytes = corpus_nbytes(corpora[label].embs)
        per_doc[label] = nbytes / corpora[label].n_docs
        print(f"corpus {label}: {per_doc[label]:.2f} resident bytes/doc "
              f"({nbytes / 1e9:.3f} GB; {per_doc['f32'] / per_doc[label]:.3f}"
              f"x below f32), built in {time.perf_counter() - t:.1f} s",
              flush=True)
    if per_doc["f32"] / per_doc["int8"] < 3.5:
        fail(f"int8 is only {per_doc['f32'] / per_doc['int8']:.3f}x below "
             "f32 in resident bytes per doc (< 3.5)")

    steps = {"dense": make_serving_step("dense", topk=K),
             "pooled": make_serving_step("bandit", topk=K, engine="pooled"),
             "pooled_chain": make_serving_step("bandit", topk=K,
                                               engine="pooled_chain")}
    q_kernel_of = {"dense": "maxsim_q", "pooled": "fused_reveal_q",
                   "pooled_chain": "gather_maxsim_q"}
    q_launches = dict.fromkeys(q_kernel_of.values(), 0)
    res5 = {}
    seeds = TorchDraws().keys(SEED, nq, "cuda")     # serve_queries' seeds
    for fmt, corpus in corpora.items():
        args = (corpus.embs, corpus.mask, queries, cand.doc_ids, cand.a,
                cand.b)
        for label, step in steps.items():
            call = functools.partial(step, *args, seeds)
            _build.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = call()
            torch.cuda.synchronize()
            first = time.perf_counter() - t
            counts = dict(_build.LAUNCHES)
            runs = []
            for _ in range(3):
                t = time.perf_counter()
                call()
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t)
            step_ms = statistics.median(runs) * 1e3
            res5[fmt, label] = [x.cpu().numpy() for x in got]
            scores, ids, frac, stats = res5[fmt, label]
            print(f"compressed {fmt} {label}: launches {counts}; first call "
                  f"{first * 1e3:.1f} ms; rerank step alone (excludes stage "
                  f"1) median of 3 warm calls {step_ms:.1f} ms per batch of "
                  f"{nq}; mean reveal_fraction {frac.mean():.4f}; stats "
                  f"{stats.tolist()}", flush=True)
            want, other = ((kernel_of[label], q_kernel_of.values())
                           if fmt == "f32" else
                           (q_kernel_of[label], kernel_of.values()))
            rows = "DenseRows" if fmt == "f32" else "QuantRows"
            body = "maxsim_kernel" if label == "dense" else "reveal_kernel"
            print(profiled_line(f"compressed {fmt} {label}", call, step_ms,
                                f"{body}<{rows}", (want,)), flush=True)
            if counts[want] == 0 or any(counts[k] for k in other):
                fail(f"compressed {fmt} {label}: launches {counts}")
            if fmt != "f32":
                q_launches[want] += counts[want]
            if ids.shape != (nq, K) or not np.isfinite(
                    scores[ids >= 0]).all():
                fail(f"compressed {fmt} {label}: malformed result")

    def overlap(a, b):
        return float(overlap_at_k(torch.as_tensor(a),
                                  torch.as_tensor(b)).mean())

    for fmt in corpora:
        fused, chain = res5[fmt, "pooled"], res5[fmt, "pooled_chain"]
        if not (np.array_equal(fused[1], chain[1])
                and np.array_equal(fused[2], chain[2])):
            fail(f"compressed {fmt}: fused and chain round bodies disagree")
        ov = overlap(fused[1], res5[fmt, "dense"][1])
        ov_f32 = overlap(res5[fmt, "dense"][1], res5["f32", "dense"][1])
        frac = float(fused[2].mean())
        print(f"check compressed {fmt}: chain == fused (identical topk_ids "
              f"and reveal_fraction); bandit overlap@{K} with dense of the "
              f"same format {ov:.4f} (>= 0.9); dense overlap@{K} with f32 "
              f"dense {ov_f32:.4f} (>= 0.9); mean reveal_fraction "
              f"{frac:.4f} (< 1)", flush=True)
        if ov < 0.9 or ov_f32 < 0.9 or not frac < 1.0:
            fail(f"compressed {fmt}: fidelity below the bar")
    print(f"check f32 corpus dense == phase 4 dense ids: "
          f"{np.array_equal(res5['f32', 'dense'][1], out['dense'].topk_ids)}",
          flush=True)

    for kname, n in q_launches.items():
        records[kname]["launches"] = n

    print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
    # 6. tile-masked scoring ---------------------------------------------------
    # Tile grid bn = bt = 8 (the op's default); seeded random tile masks.
    BN = 8

    def masked_bound(e, m, q, tm):
        """Bytes: valid tokens, masks and sidecars of the docs with an
        active tile, the query, the tile mask and the output. Flops: 2 M
        (valid length) per active cell plus the dequant of the rows read."""
        N, L, M = e.shape
        full = tile_full(tm, BN, BN, N, q.shape[0])
        doc_on = full.any(1)
        lens = m.sum(1)
        valid = int(lens[doc_on].sum())
        flops = 2 * M * int((lens * full.sum(1)).sum())
        if isinstance(e, torch.Tensor):
            nbytes = valid * M * e.element_size()
        else:
            nbytes = quant_bytes(e, valid, M) if valid else 0
            flops += dequant_ops(e, valid, M)
        nbytes += (int(doc_on.sum()) * L + q.numel() * q.element_size()
                   + tm.numel() + full.numel() * 4)
        return nbytes, flops, float(doc_on.float().mean())

    # (a) the entry point per query, on phase 4's candidate slabs.
    n_cand = docs.shape[1]
    slabs = [(docs[b].contiguous(), dmask[b].contiguous(),
              queries[b].contiguous(), tile_mask(n_cand, 32, BN, BN, 0.4))
             for b in range(nq)]
    _build.reset_launches()
    got_a = [masked_maxsim_op(*s_, block_n=BN, block_t=BN) for s_ in slabs]
    torch.cuda.synchronize()
    launches_a = dict(_build.LAUNCHES)
    if launches_a["masked_maxsim"] != nq or sum(launches_a.values()) != nq:
        fail(f"phase 6a: launches {launches_a}, want {nq} masked_maxsim")
    twins = maxsim_batch_cuda(docs.contiguous(), dmask.contiguous(),
                              queries)
    err_a = max(check_masked(f"phase 6a query {b}", *slabs[b], BN, BN,
                             got_a[b], twin=twins[b]) for b in range(nq))
    it = [0]

    def nxt_slab():
        it[0] += 1
        return slabs[it[0] % nq]

    sums = [masked_bound(*s_[:3], s_[3]) for s_ in slabs]
    b_ms, b_by = bound(statistics.mean(x[0] for x in sums),
                       statistics.mean(x[1] for x in sums))
    records["masked_maxsim"] = dict(
        name="masked_maxsim", route="cuda",
        source="src/repro_torch/kernels/csrc/maxsim.cu",
        replaces="src/repro/kernels/masked_maxsim.py:97", max_abs_err=err_a,
        ms=cuda_ms(lambda: masked_maxsim_cuda(*nxt_slab(), BN, BN)),
        plain_ms=cuda_ms(lambda: masked_maxsim_plain(*nxt_slab(), BN, BN),
                         reps=5, inner=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    def pass_a():
        for s_ in slabs:
            masked_maxsim_op(*s_, block_n=BN, block_t=BN)

    runs = []
    for _ in range(3):
        t = time.perf_counter()
        pass_a()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t)
    wall_a = statistics.median(runs) * 1e3
    print(f"phase 6a: {nq} calls of masked_maxsim_op in {wall_a:.3f} ms of "
          f"wall time (median of 3), {wall_a / nq:.4f} ms per call", flush=True)
    print(profiled_line("phase 6a", pass_a, wall_a, "masked_maxsim<DenseRows",
                        ("masked_maxsim",)), flush=True)
    print(f"phase 6a: launches {launches_a}; {nq} slabs N={n_cand} "
          f"L=128 T=32 M=128 bn=bt={BN} density 0.4 (docs with an active "
          f"tile {statistics.mean(x[2] for x in sums):.4f}); max_abs_err "
          f"{err_a:.3g} ok; == where(tile, maxsim twin, 0) bit for bit; "
          f"{json.dumps(records['masked_maxsim'])}", flush=True)

    # (b) one bulk launch over each resident corpus against query 0.
    q0 = queries[0].contiguous()
    bulk = {"f32": (index.doc_embs, index.doc_mask),
            "int8": (corpora["int8"].embs, corpora["int8"].mask),
            "residual": (corpora["residual"].embs, corpora["residual"].mask)}
    n_docs = index.doc_embs.shape[0]
    densities = (0.0, 0.1, 0.4, 1.0)
    bulk_tm = {d: tile_mask(n_docs, 32, BN, BN, d) for d in densities}
    _build.reset_launches()
    got_b = {(fmt, d): masked_maxsim_op(e, m, q0, bulk_tm[d], block_n=BN,
                                        block_t=BN)
             for fmt, (e, m) in bulk.items() for d in densities}
    torch.cuda.synchronize()
    launches_b = dict(_build.LAUNCHES)
    if (launches_b["masked_maxsim"] != 4 or launches_b["masked_maxsim_q"] != 8
            or sum(launches_b.values()) != 12):
        fail(f"phase 6b: launches {launches_b}")
    ratios = {}
    for fmt, (e, m) in bulk.items():
        quant = fmt != "f32"
        kernel = masked_maxsim_q_cuda if quant else masked_maxsim_cuda
        twin_fn = maxsim_batch_q_cuda if quant else maxsim_batch_cuda
        e1 = corpus_reshape(e, 1, n_docs)
        twin = twin_fn(e1, m[None], q0[None])[0]
        dense_ms = cuda_ms(lambda: twin_fn(e1, m[None], q0[None]))
        valid, M = int(m.sum()), e.shape[-1]
        nbytes = ((quant_bytes(e, valid, M) if quant else valid * M * 4)
                  + m.numel() + q0.numel() * 4 + n_docs * 32 * 4)
        b_ms, b_by = bound(nbytes, 2 * 32 * M * valid
                           + (dequant_ops(e, valid, M) if quant else 0))
        dev_ms = device_ms(lambda: twin_fn(e1, m[None], q0[None]),
                           "maxsim_kernel<" + ("QuantRows" if quant
                                               else "DenseRows"), n=5)
        print(f"phase 6b {fmt} dense twin N={n_docs} T=32: {dense_ms:.4f} ms "
              f"(events), device {dev_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by})", flush=True)
        for d in densities:
            tm = bulk_tm[d]
            got = got_b[fmt, d]
            err = check_masked(f"phase 6b {fmt} density {d}", e, m, q0, tm,
                               BN, BN, got, twin=twin)
            if d == 0.0 and got.any():
                fail(f"phase 6b {fmt}: density 0 must give all zeros")
            nbytes, flops, on = masked_bound(e, m, q0, tm)
            b_ms, b_by = bound(nbytes, flops)
            ms = cuda_ms(lambda: kernel(e, m, q0, tm, BN, BN))
            rec = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
            if fmt == "int8" and d == 0.4:
                rec["plain_ms"] = cuda_ms(
                    lambda: masked_maxsim_plain(e, m, q0, tm, BN, BN),
                    reps=5, inner=3)
                records["masked_maxsim_q"] = dict(
                    name="masked_maxsim_q", route="cuda",
                    source="src/repro_torch/kernels/csrc/maxsim.cu",
                    replaces="src/repro/kernels/masked_maxsim.py:56",
                    library_ms=None, **rec)
            ratios.setdefault(fmt, {})[str(d)] = ms / dense_ms
            print(f"phase 6b {fmt} N={n_docs} T=32 tile mask "
                  f"{tuple(tm.shape)} density {d}: docs with an active tile "
                  f"{on:.4f}; masked {ms:.4f} ms against dense "
                  f"{dense_ms:.4f} ms (ratio {ms / dense_ms:.4f}); "
                  f"{json.dumps(rec)}", flush=True)
    print(f"phase 6b masked / dense twin (events) by format and tile "
          f"density: {json.dumps(ratios)}", flush=True)
    print(f"phase 6b: launches {launches_b}", flush=True)
    records["masked_maxsim"]["launches"] = (launches_a["masked_maxsim"]
                                            + launches_b["masked_maxsim"])
    records["masked_maxsim"]["max_abs_err"] = masked_err["masked_maxsim"]
    records["masked_maxsim_q"]["launches"] = launches_b["masked_maxsim_q"]
    records["masked_maxsim_q"]["max_abs_err"] = masked_err["masked_maxsim_q"]

    print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
    # 7. continuous batching ---------------------------------------------------
    # 48 requests (query qi under seed group g) stream through nq slots of
    # make_streaming_step; a harvested slot takes the next request. Each
    # request is held to the one-shot batch step on its (query, seed).
    bcfg = BanditConfig(k=K)
    step_kw = dict(topk=K, alpha_ef=bcfg.alpha_ef, delta=bcfg.delta,
                   block_docs=bcfg.block_docs,
                   block_tokens=bcfg.block_tokens)
    draws = TorchDraws()
    group_seeds = [draws.keys(SEED + g, nq, "cuda")
                   for g in range(STREAM_SEEDS)]
    requests = [(qi, g) for g in range(STREAM_SEEDS) for qi in range(nq)]
    n_cand, n_tok = cand.doc_ids.shape[1], queries.shape[1]
    stream_steps = {fused: make_streaming_step(trip_limit=TRIP_LIMIT,
                                               fused=fused, **step_kw)
                    for fused in (True, False)}
    whole = make_streaming_step(trip_limit=2 ** 31, **step_kw)
    reveal_of = {"f32": ("fused_reveal", "gather_maxsim"),
                 "int8": ("fused_reveal_q", "gather_maxsim_q")}
    dense_ids = {"f32": out["dense"].topk_ids, "int8": res5["int8", "dense"][1]}

    def stream(corpus, bodies):
        """Serve every request through nq slots, cycling the round bodies
        per slice; {request: (ids, frac, rounds, revealed)}, slices, s."""
        state = init_stream_state(nq, n_cand, n_tok, device="cuda")
        queue = list(range(len(requests)))
        slot_r = [queue.pop(0) for _ in range(nq)]
        fresh = torch.ones(nq, dtype=torch.bool, device="cuda")
        got, slices = {}, 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        while len(got) < len(requests):
            qi = torch.tensor([requests[r][0] for r in slot_r], device="cuda")
            sd = torch.stack([group_seeds[requests[r][1]][requests[r][0]]
                              for r in slot_r])
            _, ids, frac, _, harvest, state = stream_steps[
                bodies[slices % len(bodies)]](
                corpus.embs, corpus.mask, queries[qi], cand.doc_ids[qi],
                cand.a[qi], cand.b[qi], state, fresh, sd)
            slices += 1
            rev = (state.cellvals < _REV_THRESH).reshape(nq, n_cand, n_tok)
            harvest, ids, frac = harvest.cpu(), ids.cpu(), frac.cpu()
            rounds = state.rounds.cpu()
            refill = torch.zeros(nq, dtype=torch.bool)
            for s_ in range(nq):
                if harvest[s_] and slot_r[s_] not in got:
                    got[slot_r[s_]] = (ids[s_], frac[s_], rounds[s_],
                                       rev[s_].clone())
                    if queue:
                        slot_r[s_] = queue.pop(0)
                        refill[s_] = True
            fresh = refill.to("cuda")
        torch.cuda.synchronize()
        return got, slices, time.perf_counter() - t

    for fmt, corpus in (("f32", corpora["f32"]), ("int8", corpora["int8"])):
        args = (corpus.embs, corpus.mask, queries, cand.doc_ids, cand.a,
                cand.b)
        # One-shot: the batch step per seed group (timed), and the same
        # pooled run as one unlimited slice for its per-query rounds.
        one, whole_rounds = {}, {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        for g in range(STREAM_SEEDS):
            one[g] = [x.cpu() for x in rerank_bandit_step(
                *args, group_seeds[g], **step_kw)]
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t
        for g in range(STREAM_SEEDS):
            _, w_ids, w_frac, _, _, w_state = whole(
                *args, init_stream_state(nq, n_cand, n_tok, device="cuda"),
                torch.ones(nq, dtype=torch.bool, device="cuda"),
                group_seeds[g])
            if not (torch.equal(w_ids.cpu(), one[g][1])
                    and torch.equal(w_frac.cpu(), one[g][2])):
                fail(f"phase 7 {fmt}: one unlimited slice differs from "
                     "rerank_bandit_step")
            whole_rounds[g] = w_state.rounds.cpu()
        fused_k, chain_k = reveal_of[fmt]
        runs = {}
        for label, bodies in (("fused", (True,)), ("alternate", (True, False))):
            _build.reset_launches()
            runs[label] = stream(corpus, bodies)
            counts = dict(_build.LAUNCHES)
            got, slices, secs = runs[label]
            n_reveal = counts[fused_k] + counts[chain_k]
            if (counts[fused_k] == 0 or (label == "alternate"
                                         and counts[chain_k] == 0)
                    or n_reveal != sum(counts.values())):
                fail(f"phase 7 {fmt} {label}: launches {counts}")
            records[fused_k]["launches"] += counts[fused_k]
            records[chain_k]["launches"] += counts[chain_k]
            print(f"phase 7 {fmt} {label} stream: {len(requests)} requests "
                  f"through {nq} slots, {slices} slices, {n_reveal - slices} "
                  f"trips, {n_reveal / slices:.2f} reveal launches per slice "
                  f"(one init + trips); launches {counts}; {secs * 1e3:.1f} "
                  f"ms = {len(requests) / secs:.1f} requests/s", flush=True)
        bad = []
        for r, (qi, g) in enumerate(requests):
            ids, frac, rounds, _ = runs["fused"][0][r]
            if not (torch.equal(ids, one[g][1][qi])
                    and torch.equal(frac, one[g][2][qi])
                    and int(rounds) == int(whole_rounds[g][qi])):
                bad.append(r)
            if not torch.equal(runs["alternate"][0][r][3],
                               runs["fused"][0][r][3]):
                bad.append(r)
        if bad:
            fail(f"phase 7 {fmt}: requests {sorted(set(bad))} differ from "
                 "one-shot or between the fused and alternating streams")
        ids_all = torch.stack([runs["fused"][0][r][0]
                               for r in range(len(requests))])
        dense_all = torch.as_tensor(dense_ids[fmt])[
            torch.tensor([qi for qi, _ in requests])]
        ov = float(overlap_at_k(ids_all, dense_all).mean())
        frac_all = float(torch.stack([runs["fused"][0][r][1]
                                      for r in range(len(requests))]).mean())
        print(f"phase 7 {fmt}: every request == one-shot rerank_bandit_step "
              f"(ids, reveal fraction, rounds); alternating fused/chain "
              f"slices reveal the same cells; one-shot {STREAM_SEEDS} "
              f"batches of {nq} in {one_s * 1e3:.1f} ms = "
              f"{len(requests) / one_s:.1f} requests/s against streamed "
              f"{len(requests) / runs['fused'][2]:.1f}; overlap@{K} with "
              f"dense {ov:.4f} (>= 0.9); mean reveal fraction "
              f"{frac_all:.4f}; {smi}", flush=True)
        if ov < 0.9:
            fail(f"phase 7 {fmt}: overlap@{K} {ov} < 0.9")

    # Fidelity knobs on seed group 0's batch (f32).
    args = (index.doc_embs, index.doc_mask, queries, cand.doc_ids, cand.a,
            cand.b, group_seeds[0])
    base = rerank_bandit_step(*args, **step_kw)
    knob = rerank_bandit_step(
        *args, alpha_scale=torch.tensor(1.0, device="cuda"),
        round_cap=torch.tensor(0, device="cuda"), **step_kw)
    if not all(torch.equal(x, y) for x, y in zip(base, knob)):
        fail("phase 7: alpha_scale=1.0 differs from no knob")
    # The default ladder's 4 levels. A round cap bounds a query's rounds,
    # so the capped levels must not reveal more than level 0 nor rise from
    # one capped level to the next (the reference's own acceptance, BENCH_
    # chaos "ladder_no_extra_reveal_work", is level 3 <= level 0). Level 1
    # only scales alpha_ef: wider Serfling radii separate later, so it may
    # reveal more than level 0; that is the reference's behaviour (its
    # docstring, src/repro/serve/resilience.py:22-23, says the opposite) and
    # is printed, not held.
    ladder, fracs = DegradeLadder(), []
    for level in range(ladder.n_levels):
        a_s, cap = ladder.knobs(level)
        kn = dict(alpha_scale=torch.tensor(a_s, device="cuda"),
                  round_cap=torch.tensor(cap, device="cuda"))
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, ids, frac, stats = rerank_bandit_step(*args, **kn, **step_kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        fracs.append(float(frac.mean()))
        ov = float(overlap_at_k(ids.cpu(),
                                torch.as_tensor(dense_ids["f32"])).mean())
        print(f"phase 7 ladder level {level} (alpha_scale {a_s}, round_cap "
              f"{cap}): mean reveal fraction {fracs[-1]:.4f}, total rounds "
              f"{int(stats[1])}, {ms:.1f} ms per batch of {nq}, overlap@{K} "
              f"with dense {ov:.4f}", flush=True)
        if cap > 0 and int(stats[1]) > nq * cap:
            fail(f"phase 7 ladder level {level}: {int(stats[1])} rounds "
                 f"beyond the cap {cap} x {nq} queries")
    capped = [lv for lv in range(ladder.n_levels)
              if lv == 0 or ladder.knobs(lv)[1] > 0]
    held = [fracs[lv] for lv in capped]
    print(f"phase 7: alpha_scale=1.0 == no knob bit for bit; ladder reveal "
          f"fractions by level {fracs}; levels {capped} (level 0 and the "
          f"round-capped) must not rise: {held}; level 1 (alpha_scale only) "
          f"{fracs[1] - fracs[0]:+.4f} against level 0", flush=True)
    if any(f2 > f1 for f1, f2 in zip(held, held[1:])):
        fail(f"phase 7: the capped levels' reveal fraction rose: {held}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, lock_ids, lock_frac, lock_stats = rerank_bandit_step(
        *args, engine="vmapped", **step_kw)
    torch.cuda.synchronize()
    print(f"phase 7 engine=vmapped: {(time.perf_counter() - t) * 1e3:.1f} ms "
          f"per batch of {nq}; overlap@{K} with pooled "
          f"{float(overlap_at_k(lock_ids, base[1]).mean()):.4f}; "
          f"lockstep_waste {float(lock_stats[2]):.0f} rounds (occupancy "
          f"{float(lock_stats[0]):.4f}); mean reveal fraction "
          f"{float(lock_frac.mean()):.4f}", flush=True)
    if lock_ids.shape != (nq, K) or not torch.isfinite(
            lock_stats).all():
        fail("phase 7: malformed vmapped result")

    print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
    # 8. research harness ------------------------------------------------------
    # evaluate_dataset per method, H from the maxsim kernel. Every H it
    # computed is then held to maxsim_plain on the same inputs, and the
    # same run with H from the plain version must give each query the same
    # top-K ids and coverage.
    @contextlib.contextmanager
    def swapped(name, fn):
        old = getattr(pipeline, name)
        setattr(pipeline, name, fn)
        try:
            yield old
        finally:
            setattr(pipeline, name, old)

    def harness_run(method, h_fn, **kw):
        rows, hs = [], []

        def rerank(*a, **k):
            rows.append(real_rerank(*a, **k))
            return rows[-1]

        def h(embs, mask, q):
            hs.append((embs, mask, q, h_fn(embs, mask, q)))
            return hs[-1][-1]

        with swapped("rerank_query", rerank) as real_rerank, \
                swapped("maxsim_op", h):
            out = evaluate_dataset(ds8, method=method, k=K, bandit=bcfg,
                                   index=index, max_candidates=MAX_CANDIDATES,
                                   **kw)
        return out, rows, hs

    harness, err8 = {}, 0.0
    ds8 = dataclasses.replace(ds, queries=ds.queries[:HARNESS_QUERIES],
                              qrels=ds.qrels[:HARNESS_QUERIES])
    for label, method, kw in (("exact", "exact", {}),
                              ("bandit", "bandit", {}),
                              ("bandit+prereveal_ann", "bandit",
                               dict(prereveal_ann=True)),
                              ("batched", "batched", {}),
                              ("uniform", "uniform", {}),
                              ("topmargin", "topmargin", {})):
        _build.reset_launches()
        t = time.perf_counter()
        harness[label], rows, hs = harness_run(method, pipeline.maxsim_op,
                                               **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = dict(_build.LAUNCHES)
        if counts["maxsim"] != HARNESS_QUERIES or sum(counts.values()) != \
                HARNESS_QUERIES:
            fail(f"phase 8 {label}: launches {counts}")
        records["maxsim"]["launches"] += counts["maxsim"]
        for qi, (embs, mask, q, got) in enumerate(hs):
            err8 = max(err8, check_close(f"phase 8 {label} query {qi} H",
                                         got, maxsim_plain(embs, mask, q)))
        _, plain_rows, _ = harness_run(method, maxsim_plain, **kw)
        same = [np.array_equal(r.topk_docs, p.topk_docs)
                and r.coverage == p.coverage
                for r, p in zip(rows, plain_rows)]
        if len(same) != HARNESS_QUERIES or not all(same):
            fail(f"phase 8 {label}: top-K ids or coverage differ from the "
                 f"run with H from maxsim_plain, per query {same}")
        r = harness[label]
        print(f"phase 8 {label}: {HARNESS_QUERIES} queries in {secs:.1f} s; "
              f"coverage {r['coverage']:.4f}, overlap {r['overlap']:.4f}, "
              f"flops_saving {r['flops_saving']:.3f}, recall "
              f"{r['recall']:.4f}, ndcg {r['ndcg']:.4f}; launches "
              f"{counts['maxsim']} maxsim; H == maxsim_plain within "
              f"rtol={RTOL}, atol={ATOL}; top-K ids and coverage == the run "
              f"with the plain H, per query", flush=True)
    if harness["exact"]["overlap"] != 1.0 or \
            not harness["bandit"]["coverage"] < 1.0:
        fail("phase 8: exact must overlap 1.0 and the bandit's coverage be "
             "below 1")
    print(f"phase 8: max |H kernel - H plain| over every query and method "
          f"{err8:.3g}", flush=True)

    print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
    # 9. serving engine --------------------------------------------------------
    served = serving_engine(torch.device("cuda"), index, ds, cand, records,
                            profiled_line, smi, t_start)
    print(f"phase 9: launches in the served runs {dict(served)}", flush=True)
    for kname, n in served.items():
        records[kname]["launches"] += n
    print(f"elapsed {time.perf_counter() - t_start:.1f} s (end)", flush=True)

    order = ("fused_reveal", "maxsim", "gather_maxsim", "fused_reveal_q",
             "maxsim_q", "gather_maxsim_q", "masked_maxsim", "masked_maxsim_q")
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
