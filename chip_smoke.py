#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # one CUDA card; exits non-zero on any failure

Phases, in order:
  1. device: the card's name and power limit (``nvidia-smi``);
  2. build: ``nvcc`` compiles the kernels from ``src/repro_torch/kernels/csrc``
     (ptxas registers and spills per instantiation; a spill in ``maxsim.cu``
     fails the run);
  3. kernels: each CUDA kernel against its plain PyTorch version on the card,
     at the serving path's shapes plus edge cases (G = 96 and 128 query
     rows a frontier row, residual codebooks of Kc = 1,024), with timings
     and bounds;
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
     ``serving_engine``);
 10. sharded serving: phase 4's f32 corpus and its int8 encoding split
     into 4 shards on the one card, phase 4's candidates routed to them:
     the sharded dense, budgeted, two-phase and bandit steps held to the
     single-device results, routed stage 1 held to the host-routed step
     bit for bit on a slab and run at full size, and the engine on the
     mesh with a shard failover, each completion held to the sharded or
     routed step bit for bit (see ``sharded_serving``);
 11. launch-shape tuning and the serving-contract audit: every candidate
     launch shape timed at the serving buckets, an autotuned engine held
     to an untuned one bit for bit and its table reloaded, ``audit=True``
     engines (f32, int8, the S = 4 mesh, routed) with their reports, and
     a host copy in a step failing the audit (see ``tuning_and_audit``);
 12. LM serving and the late-interaction encoder at Qwen2.5-3B's full
     width: ``generate`` timed at B = 8 (prefill, decode per step, bounds),
     decode held to ``forward_train`` in float32 (Qwen2.5-3B at full depth,
     gemma2-27b's first layer pair across the ring's wrap), the encoder on
     the card held to the CPU, and tokens to Col-Bandit's top-K through
     ``serve_queries`` on the encoder's embeddings (see ``lm_serving``);
 13. the MoE backbones, the recsys zoo and the generalized Col-Bandit:
     Moonlight-16B-A3B at full width and depth in bf16 (``generate`` timed
     beside its bounds, the experts each decode layer routes to, its
     embeddings served dense / fused / chain), decode held to
     ``forward_train`` in float32 with no token dropped (Moonlight and
     Mixtral 8x22B at full width, 2 layers) and the encoder on the card to
     the CPU, both under the routing rule; FM, AutoInt, DIN and SASRec at
     full width (``serve_p99``, ``retrieval_cand`` over 10^6 candidates,
     card == CPU), and ``topk_bandit_generalized`` on the benchmark's grid
     and on FM's components (see ``moe_and_recsys``);
 14. training: Qwen2.5-3B at full width and depth in bf16 (B = 2 x 4,096,
     remat, chunked CE, AdamW; step ms beside its bound, tokens/s, peak
     memory, a profiled step), one step at 2 layers card == CPU and
     microbatches 2 == 1, the crash-and-resume run bit for bit in a child
     process (``--train-resume``) under deterministic algorithms, a
     Moonlight-16B-A3B step at 2 layers card == CPU, PNA on three graph
     shapes and its sharded loss, the recsys ``train_batch`` steps, and
     the int8-compressed data-parallel step at S = 4 (see ``training``);
 15. long-context decode: Qwen2.5-3B at full width and depth over
     ``long_500k``'s 524,288-slot bf16 cache, split-K over 4 sequence
     shards on the card against the plain decode (ms a step, bound, idle
     share, peak; the gate in float32), gemma2-27b's first layer pair on a
     (2, 4) mesh with batch blocks, the ring collectives on 4 shards, and
     the thread-access recorder on the continuous engine (see
     ``long_context``);
 16. the launcher's account: one cell per family on the (16, 16)
     production mesh at full depth, accounted on the host (exact placement
     bytes, FLOPs and bytes counted on ``meta``, reckoned collectives, the
     H100's roofline seconds), and three cells on a one-card mesh held to
     the card: argument bytes == the arguments' ``nbytes``, counted FLOPs
     == ``FlopCounterMode`` over the card's run, the dense ``maxsim``
     kernel launched as the account expects, step ms beside the account's
     bound (see ``launcher_account``).

The last two lines of standard output are the device line and
``{"ok": true, "device": {...}}``; the line before them lists every kernel as
JSON. TF32 is switched off for matrix products and cuDNN, so every float32
reference product runs in full float32.
"""
import contextlib
import dataclasses
import functools
import json
import os
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
HARNESS_QUERIES = 1     # phase 8: queries per method (2 took ~146 s;
                        # with phase 14 the script then passed 950 s)
# Phase 12: decode logits against forward_train over 36 float32 layers of
# products summed in another order (JAX's own test: 1e-4 at 2 layers of
# width 64), and card against CPU embeddings (unit rows, 2 layers).
LM_ATOL, ENC_ATOL = 1e-3, 1e-5
# Phase 13: a router top-k gap (k-th minus (k+1)-th logit) below MOE_TIE may
# flip under float noise, so two computations may route such a token
# differently; recsys scores card against CPU in float32.
MOE_TIE, REC_ATOL = 1e-4, 1e-5
# Phase 14: PNA's std = sqrt(E[x^2] - E[x]^2 + 1e-8) cancels where a
# node's messages are large and close, and the card's scatters add in
# another (atomic) order: loss and per-leaf gradient errors relative to
# the CPU's (tests/test_torch_gnn.py holds the CPU to JAX at 1e-4 / 1e-3).
PNA_LOSS_REL, PNA_GRAD_REL = 1e-4, 1e-2
# Phase 15(b): a row block's product may take another cuBLAS algorithm than
# the whole one; each bf16 output is then within one bf16 ulp (2^-7 of its
# value) of the other, and RING_ATOL covers outputs near 0 (the products of
# N(0, 1) bf16 inputs over K = 2,048 are ~45 in size).
RING_RTOL, RING_ATOL = 2.0 ** -7, 1e-2
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


def sharded_serving(dev, index, ds, cand, dense4, dense_int8, step_ms5,
                    profiled_line, smi, t_start):
    """10. Sharded serving on the card: phase 4's 65,536-doc f32 corpus and
    its int8 encoding, each split into S = 4 shards on the one card (mesh
    (("data", 2), ("model", 2))), every shard a view of the one resident
    tensor; phase 4's 16 queries and stage-1 candidates routed to their
    shards by ``route_batch`` (N_loc = 256).

    (a) sharded dense, f32 and int8: top-5 id sets equal phase 4's dense
        (``dense4``) and phase 5's int8 dense (``dense_int8``), scores
        within RTOL/ATOL;
    (b) budgeted: at ``tokens_per_doc = T`` equal to (a); at 8 tokens
        every ``gather_maxsim`` launch held to ``gather_maxsim_plain``;
    (c) two-phase: ``survivors = N_loc`` equal to (a); overlap@5 printed
        at ``survivors = 2``;
    (d) sharded bandit, f32 and int8, phase 4's ``BanditConfig``:
        overlap@5 with dense >= 0.9, reveal fraction < 1, at ``alpha_ef =
        1e9`` the ids equal dense (where dense's 5th/6th gap > 1e-4), ms
        per batch beside phase 5's single-device step (``step_ms5``);
    (e) routed stage 1, dense and bandit: on a 1,024-doc slab at full
        coverage (k' = C*L, n_local = c_loc) bit-equal to the host-routed
        step; at full size with ``n_total = 256`` split by quota, overlap@5
        with phase 4's dense and the quota-share columns (reported);
    (f) ``RetrievalEngine(mesh_axes=...)``, ``stage1="host"`` (48
        requests as phase 9) and ``"local"`` (the 16 candidate-less
        ones): every completion equal to the sharded or routed step on
        the same inputs and seeds bit for bit, ``compiles_after_warmup``
        0; after ``fail_shard(1)`` no completion holds a doc of shard 1
        and each equals the step with that ``healthy`` mask; after
        ``restore_shard(1)`` the healthy results come back.

    Returns the kernels' launches in the served runs (not the checks)."""
    import collections

    from repro_torch.configs.base import BanditConfig
    from repro_torch.core.metrics import overlap_at_k
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.kernels import _build
    from repro_torch.kernels.gather_maxsim import gather_maxsim_plain
    from repro_torch.retrieval import service
    from repro_torch.retrieval.pipeline import candidates_for
    from repro_torch.retrieval.service import (make_rerank_budgeted_step,
                                               make_rerank_two_phase_step,
                                               make_routed_serving_step,
                                               make_sharded_serving_step)
    from repro_torch.retrieval.sharded import (route_aligned, route_batch,
                                               shard_corpus)
    from repro_torch.serve import (EngineConfig, Request, RetrievalEngine,
                                   pad_candidates, support_bounds)

    t_phase = time.perf_counter()
    axes = (("data", 2), ("model", 2))
    mesh = make_mesh((2, 2), ("data", "model"), device=dev)
    S = mesh.size
    nq, T, M = ds.queries.shape
    queries = torch.as_tensor(ds.queries, device=dev)
    served = collections.Counter()
    bcfg = BanditConfig(k=K)                  # phase 4's
    bkw = dict(alpha_ef=bcfg.alpha_ef, delta=bcfg.delta,
               block_docs=bcfg.block_docs, block_tokens=bcfg.block_tokens)

    def sync_dev():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def counted(fn, tally=True):
        """Run ``fn`` once: its result, launches and seconds."""
        _build.reset_launches()
        sync_dev()
        t = time.perf_counter()
        res = fn()
        sync_dev()
        secs = time.perf_counter() - t
        counts = {k: v for k, v in _build.LAUNCHES.items() if v}
        if tally:
            served.update(counts)
        return res, counts, secs

    def warm_ms(fn, n=3):
        runs = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            sync_dev()
            runs.append(time.perf_counter() - t)
        return statistics.median(runs) * 1e3

    def np_(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else x

    def same_sets(label, got, want, gaps=None):
        """Top-K id sets per query (queries with a 5th/6th gap <= 1e-4 in
        ``gaps`` skipped) and, without ``gaps``, sorted scores within
        RTOL/ATOL. Returns the queries checked."""
        gs, gi = np_(got[0]), np_(got[1])
        ws, wi = np_(want[0]), np_(want[1])
        rows = [b for b in range(nq) if gaps is None or gaps[b] > 1e-4]
        bad = [b for b in rows if set(gi[b]) != set(wi[b])]
        if bad:
            fail(f"phase 10 {label}: queries {bad} differ in top-{K} ids")
        if gaps is None and not np.allclose(np.sort(gs, 1), np.sort(ws, 1),
                                            rtol=RTOL, atol=ATOL):
            fail(f"phase 10 {label}: scores beyond rtol={RTOL}, "
                 f"atol={ATOL}")
        return len(rows)

    def overlap(a, b):
        return float(overlap_at_k(torch.as_tensor(np_(a)),
                                  torch.as_tensor(np_(b))).mean())

    def bitwise(label, got, want):
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            fail(f"phase 10 {label}: not bit-equal")

    # The sharded corpora ----------------------------------------------------
    t = time.perf_counter()
    C = index.doc_embs.shape[0]
    pooled = torch.empty((C, M), dtype=torch.float32, device=dev)
    for c0 in range(0, C, 4096):                 # masked mean, in chunks
        e, m = index.doc_embs[c0:c0 + 4096], index.doc_mask[c0:c0 + 4096]
        pooled[c0:c0 + 4096] = ((e * m[..., None]).sum(1)
                                / m.sum(1, keepdim=True).clamp(min=1))
    sc = shard_corpus(index.doc_embs, index.doc_mask, mesh, pooled=pooled,
                      n_centroids=8)
    sc8 = shard_corpus(index.doc_embs, index.doc_mask, mesh,
                       corpus_format="int8")
    sync_dev()
    dps = sc.docs_per_shard
    views = all(p.data_ptr() == index.doc_embs[s * dps].data_ptr()
                for s, p in enumerate(sc.embs.parts))
    if not views or sc.n_shards != S:
        fail("phase 10: the f32 shards are not views of phase 4's corpus")
    print(f"phase 10 corpus: {S} shards of {dps} docs on {dev}, f32 shards "
          f"are views of phase 4's resident tensor (no copy), int8 "
          f"{sc8.embs.whole.data.numel() / 1e9:.3f} GB payload, pooled "
          f"summaries and an 8-centroid router; built in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    ids4 = cand.doc_ids.cpu().numpy()
    cl, (al, bl) = route_batch(ids4, (cand.a.cpu().numpy(),
                                      cand.b.cpu().numpy()), dps, S)
    cl_t, al_t, bl_t = (torch.as_tensor(x, device=dev) for x in (cl, al, bl))
    per_shard = (cl >= 0).sum(2).sum(0).tolist()
    print(f"phase 10 routing: {int((ids4 >= 0).sum())} candidates -> "
          f"(16, {S}, {cl.shape[2]}) slots; per shard {per_shard}",
          flush=True)
    args = (queries, cl_t, al_t, bl_t, sc.valid_docs, 0)

    # (a) sharded dense -------------------------------------------------------
    dense = {}
    gaps = {}
    for fmt, corpus, want, kname in (("f32", sc, dense4, "maxsim"),
                                     ("int8", sc8, dense_int8, "maxsim_q")):
        cf = "bf16" if fmt == "f32" else fmt
        step = make_sharded_serving_step(mesh, "dense", topk=K,
                                         corpus_format=cf)
        call = functools.partial(step, corpus.embs, corpus.mask, *args)
        got, counts, _ = counted(call)
        six = np_(make_sharded_serving_step(
            mesh, "dense", topk=K + 1, corpus_format=cf)(
            corpus.embs, corpus.mask, *args)[0])
        gaps[fmt] = six[:, K - 1] - six[:, K]
        if counts.get(kname) != S or len(counts) != 1:
            fail(f"phase 10a {fmt}: launches {counts}, want {S} {kname}")
        same_sets(f"(a) dense {fmt}", got, want)
        dense[fmt] = got
        print(f"phase 10a dense {fmt}: top-{K} ids == single-device dense, "
              f"scores within rtol={RTOL}, atol={ATOL}; launches {counts}; "
              f"{warm_ms(call):.1f} ms per batch of {nq} (median of 3); "
              f"stats {np_(got[3]).tolist()}", flush=True)

    # (b) budgeted ------------------------------------------------------------
    tok = np.broadcast_to(np.arange(T, dtype=np.int32)[None, None],
                          (nq, ids4.shape[1], T))
    tok_l = torch.as_tensor(route_aligned(tok, ids4, cl, dps), device=dev)
    full = make_rerank_budgeted_step(mesh, topk=K, tokens_per_doc=T,
                                     valid_docs=sc.valid_docs)
    got, counts, _ = counted(lambda: full(sc.embs, sc.mask, queries, cl_t,
                                          tok_l))
    same_sets("(b) budgeted at T", got, dense["f32"])
    rng = np.random.default_rng(SEED)
    tok8 = rng.integers(0, T, (nq, ids4.shape[1], 8)).astype(np.int32)
    tok8_l = torch.as_tensor(route_aligned(tok8, ids4, cl, dps), device=dev)
    step8 = make_rerank_budgeted_step(mesh, topk=K, tokens_per_doc=8,
                                      valid_docs=sc.valid_docs)
    recorded = []
    real_op = service.gather_maxsim_op

    def recording_op(*a):
        recorded.append((a, real_op(*a)))
        return recorded[-1][1]

    service.gather_maxsim_op = recording_op
    try:
        got8, counts8, _ = counted(lambda: step8(sc.embs, sc.mask, queries,
                                                 cl_t, tok8_l))
    finally:
        service.gather_maxsim_op = real_op
    if counts.get("gather_maxsim") != S or counts8.get("gather_maxsim") != S \
            or len(recorded) != S:
        fail(f"phase 10b: launches {counts} / {counts8}")
    err = max(check_close(f"phase 10b launch {i}", out,
                          gather_maxsim_plain(*a))
              for i, (a, out) in enumerate(recorded))
    call8 = functools.partial(step8, sc.embs, sc.mask, queries, cl_t, tok8_l)
    print(f"phase 10b budgeted: tokens_per_doc=T == (a) (ids, scores within "
          f"rtol={RTOL}, atol={ATOL}); 8 tokens: {len(recorded)} "
          f"gather_maxsim launches each == gather_maxsim_plain "
          f"(max_abs_err {err:.3g}), overlap@{K} with dense "
          f"{overlap(got8[1], dense['f32'][1]):.4f}; {warm_ms(call8):.1f} ms "
          f"per batch (8 tokens)", flush=True)

    # (c) two-phase -----------------------------------------------------------
    n_loc = cl.shape[2]
    for surv in (n_loc, 2):
        step = make_rerank_two_phase_step(mesh, topk=K, survivors=surv,
                                          valid_docs=sc.valid_docs)
        call = functools.partial(step, sc.embs, sc.mask, sc.pooled, queries,
                                 cl_t)
        got, counts, _ = counted(call)
        if counts.get("maxsim") != S:
            fail(f"phase 10c: launches {counts}")
        if surv == n_loc:
            same_sets("(c) two-phase at N_loc survivors", got, dense["f32"])
        print(f"phase 10c two-phase survivors={surv}: "
              + ("== (a)" if surv == n_loc else
                 f"overlap@{K} with dense "
                 f"{overlap(got[1], dense['f32'][1]):.4f}")
              + f"; launches {counts}; {warm_ms(call):.1f} ms per batch",
              flush=True)

    # (d) sharded bandit ------------------------------------------------------
    for fmt, corpus, want, kname in (("f32", sc, dense4, "fused_reveal"),
                                     ("int8", sc8, dense_int8,
                                      "fused_reveal_q")):
        cf = "bf16" if fmt == "f32" else fmt
        step = make_sharded_serving_step(mesh, "bandit", topk=K,
                                         corpus_format=cf, **bkw)
        call = functools.partial(step, corpus.embs, corpus.mask, *args)
        got, counts, first = counted(call)
        stats = np_(got[3])
        ov, frac = overlap(got[1], want[1]), float(np_(got[2]).mean())
        if not counts.get(kname) or ov < 0.9 or not frac < 1.0:
            fail(f"phase 10d {fmt}: launches {counts}, overlap {ov}, reveal "
                 f"fraction {frac}")
        ms = warm_ms(call)
        print(f"phase 10d bandit {fmt}: overlap@{K} with dense {ov:.4f} "
              f"(>= 0.9); mean reveal fraction {frac:.4f} (< 1); launches "
              f"{counts} (rounds per shard {stats[:, 1].tolist()}); "
              f"{ms:.1f} ms per batch (median of 3; first {first * 1e3:.1f})"
              f" against {step_ms5[fmt]:.1f} for phase 5's single-device "
              f"step ({ms / step_ms5[fmt]:.3f}x); {smi}", flush=True)
        if fmt == "f32":
            bandit_call, bandit_ms = call, ms
        hard = make_sharded_serving_step(mesh, "bandit", topk=K,
                                         corpus_format=cf,
                                         **dict(bkw, alpha_ef=1e9))
        gh, counts, secs = counted(functools.partial(
            hard, corpus.embs, corpus.mask, *args))
        n = same_sets(f"(d) {fmt} alpha_ef=1e9", gh, want, gaps=gaps[fmt])
        print(f"phase 10d bandit {fmt} alpha_ef=1e9: ids == dense on {n}/"
              f"{nq} queries (dense 5th/6th gap > 1e-4); reveal fraction "
              f"{float(np_(gh[2]).mean()):.4f}; {secs * 1e3:.1f} ms",
              flush=True)
    print(profiled_line("phase 10d sharded bandit f32", bandit_call,
                        bandit_ms, "reveal_kernel<DenseRows",
                        ("fused_reveal",)), flush=True)

    # (e) routed stage 1 ------------------------------------------------------
    slab_e, slab_m = index.doc_embs[:1024], index.doc_mask[:1024]
    sl = shard_corpus(slab_e, slab_m, mesh, n_centroids=8)
    kp = 1024 * slab_e.shape[1]
    hc = candidates_for(slab_e, slab_m, queries, kprime=kp,
                        max_candidates=1024, support=(0.0, 1.0))
    cl_s, (a_s, b_s) = route_batch(hc.doc_ids.cpu().numpy(),
                                   (hc.a.cpu().numpy(), hc.b.cpu().numpy()),
                                   sl.docs_per_shard, S,
                                   n_local=sl.docs_per_shard)
    for flavor in ("dense", "bandit"):
        kw = bkw if flavor == "bandit" else {}
        host = make_sharded_serving_step(mesh, flavor, topk=K, **kw)(
            sl.embs, sl.mask, queries,
            *(torch.as_tensor(x, device=dev) for x in (cl_s, a_s, b_s)),
            sl.valid_docs, 0)
        routed, counts, _ = counted(lambda: make_routed_serving_step(
            mesh, flavor, topk=K, n_local=sl.docs_per_shard, n_total=0,
            kprime=kp, **kw)(sl.embs, sl.mask, sl.router.centroids,
                             sl.router.shard_mass, queries, sl.valid_docs,
                             0))
        bitwise(f"(e) routed {flavor} on the slab", routed[:3], host[:3])
        print(f"phase 10e routed {flavor}, 1,024-doc slab at full coverage "
              f"(k'={kp}, n_local={sl.docs_per_shard}): ids, scores and "
              f"reveal fractions == the host-routed sharded step bit for "
              f"bit; launches {counts}", flush=True)
    for flavor in ("dense", "bandit"):
        kw = bkw if flavor == "bandit" else {}
        step = make_routed_serving_step(mesh, flavor, topk=K, n_local=256,
                                        n_total=256, kprime=10, **kw)
        call = functools.partial(step, sc.embs, sc.mask, sc.router.centroids,
                                 sc.router.shard_mass, queries,
                                 sc.valid_docs, 0)
        got, counts, first = counted(call)
        stats = np_(got[3])
        ms = warm_ms(call)
        print(f"phase 10e routed {flavor} full size, n_total=256 by quota: "
              f"overlap@{K} with phase 4 dense "
              f"{overlap(got[1], dense4[1]):.4f} (reported); mean reveal "
              f"fraction {float(np_(got[2]).mean()):.4f}; quota share "
              f"mean/max per shard {stats[:, 3].round(4).tolist()} / "
              f"{stats[:, 4].round(4).tolist()}; launches {counts}; "
              f"{ms:.1f} ms per batch (median of 3; first "
              f"{first * 1e3:.1f}); {smi}", flush=True)
        if flavor == "bandit":
            print(profiled_line("phase 10e routed bandit", call, ms,
                                "reveal_kernel<DenseRows",
                                ("fused_reveal",)), flush=True)

    # (f) the engine on the mesh ---------------------------------------------
    cfg = EngineConfig(batch_size=nq, deadline_s=30.0, token_buckets=(T,),
                       cand_buckets=(64, MAX_CANDIDATES), max_k=K,
                       flavor="auto", bandit_min_candidates=MAX_CANDIDATES,
                       stage1_candidates=MAX_CANDIDATES, stage1_kprime=10,
                       seed=SEED, mesh_axes=axes)
    ids = [r[r >= 0] for r in ids4]
    requests = ([Request(query=ds.queries[i], k=K, cand_ids=ids[i])
                 for i in range(nq)]
                + [Request(query=ds.queries[i], k=K, cand_ids=ids[i][:64])
                   for i in range(nq)]
                + [Request(query=ds.queries[i], k=K) for i in range(nq)])

    def serve(eng, reqs):
        def run():
            for r in reqs:
                eng.submit(r)
            return eng.drain()

        done, counts, secs = counted(run)
        got = {c.rid: c for c in done}
        if len(got) != len(done) or len(done) != len(reqs):
            fail(f"phase 10f: {len(done)} completions for {len(reqs)}")
        if eng.metrics.compiles_after_warmup:
            fail("phase 10f: builds after warmup")
        return [got[r] for r in sorted(got)], counts, secs

    def step_inputs(batch, nb):
        """The engine's routed (16, S, nb) inputs of one batch."""
        if batch[0].cand_ids is None:
            c, a, b = (x.cpu().numpy() for x in (cand.doc_ids, cand.a,
                                                  cand.b))
        else:
            c = pad_candidates([r.cand_ids for r in batch], nb)
            a, b = support_bounds(c, [T] * nq, T, cfg.support)
        c_l, routed = route_batch(c, (a, b), dps, S, n_local=nb)
        return c, [torch.as_tensor(x, device=dev) for x in (c_l, *routed)]

    def held(label, eng, comps, reqs_all, ordinals, healthy):
        """Each batch of ``comps`` (served from ``reqs_all`` in order) ==
        the sharded step at its batch ordinal."""
        for j, ordinal in enumerate(ordinals):
            batch = comps[j * nq:(j + 1) * nq]
            reqs = reqs_all[j * nq:(j + 1) * nq]
            nb = eng.buckets.cand_bucket(max(
                len(r.cand_ids) if r.cand_ids is not None
                else MAX_CANDIDATES for r in reqs))
            flavor = eng.flavor_for(nb)
            c, ins = step_inputs(reqs, nb)
            if flavor == "dense":
                ins[1] = ins[2] = torch.zeros_like(ins[1])
            want = make_sharded_serving_step(
                mesh, flavor, topk=K, base_seed=SEED)(
                eng.corpus_embs, eng.corpus_mask, queries, *ins,
                eng.corpus.valid_docs, ordinal, healthy, 1.0, 0)
            scores, gids, frac, _ = (np_(x) for x in want)
            for i, comp in enumerate(batch):
                if not (comp.flavor == flavor
                        and np.array_equal(comp.topk_ids, gids[i])
                        and np.array_equal(comp.topk_scores, scores[i])
                        and comp.reveal_fraction == float(frac[i])):
                    fail(f"phase 10f {label}: rid {comp.rid} differs from "
                         f"the sharded step")

    t = time.perf_counter()
    eng = RetrievalEngine(index.doc_embs, index.doc_mask, cfg, device=dev)
    warm = eng.warmup()
    print(f"phase 10f host engine built and warmed in "
          f"{time.perf_counter() - t:.1f} s, buckets {warm}", flush=True)
    comps, counts, secs = serve(eng, requests)
    held("host", eng, comps, requests, (0, 1, 2), np.ones(S, bool))
    s = eng.metrics.summary()
    print(f"phase 10f engine stage1='host': {len(comps)} requests in "
          f"{secs * 1e3:.1f} ms = {len(comps) / secs:.1f} requests/s; "
          f"latency p50 {s['latency_p50_ms']:.1f} ms; every completion == "
          f"the sharded step bit for bit; compiles_after_warmup "
          f"{s['compiles_after_warmup']}; shard rounds "
          f"{s['shard_rounds_total']}; launches {counts}; {smi}", flush=True)
    carrying = requests[:2 * nq]
    eng.fail_shard(1)
    healthy = np.array([True, False, True, True])
    down, counts, _ = serve(eng, carrying)
    bad = [c.rid for c in down if ((c.topk_ids >= dps)
                                   & (c.topk_ids < 2 * dps)).any()]
    if bad:
        fail(f"phase 10f: rids {bad} hold a doc of the failed shard 1")
    held("shard 1 down", eng, down, carrying, (3, 4), healthy)
    cov = np.mean([c.coverage for c in down])
    eng.restore_shard(1)
    back, _, _ = serve(eng, carrying)
    held("restored", eng, back, carrying, (5, 6), np.ones(S, bool))
    dense_again = all(np.array_equal(x.topk_ids, y.topk_ids)
                      and np.array_equal(x.topk_scores, y.topk_scores)
                      for x, y in zip(back[nq:], comps[nq:2 * nq]))
    s = eng.metrics.summary()
    if not dense_again or s["failovers"] != 1 \
            or s["shard_healthy"] != [True] * S \
            or eng.metrics.compiles_after_warmup:
        fail("phase 10f: restore did not bring the healthy results back")
    print(f"phase 10f failover: after fail_shard(1) no completion holds a "
          f"doc of shard 1, each == the step with healthy {healthy.tolist()}"
          f", mean coverage {cov:.4f}; after restore_shard(1) each == the "
          f"healthy step and the dense batch == the first pass bit for "
          f"bit; failovers {s['failovers']}; compiles_after_warmup 0; "
          f"launches while down {counts}", flush=True)

    t = time.perf_counter()
    loc = RetrievalEngine(index.doc_embs, index.doc_mask,
                          dataclasses.replace(cfg, stage1="local"),
                          device=dev)
    loc.warmup()
    print(f"phase 10f local engine built and warmed in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    local_reqs = requests[2 * nq:]
    comps, counts, secs = serve(loc, local_reqs)
    cents, mass = loc.corpus.router_arrays()
    want = make_routed_serving_step(
        mesh, "bandit", topk=K, n_local=loc._stage1_n, n_total=0,
        kprime=10, base_seed=SEED)(loc.corpus_embs, loc.corpus_mask, cents,
                                   mass, queries, loc.corpus.valid_docs, 0,
                                   np.ones(S, bool), 1.0, 0)
    scores, gids, frac, _ = (np_(x) for x in want)
    for i, c in enumerate(comps):
        if not (np.array_equal(c.topk_ids, gids[i])
                and np.array_equal(c.topk_scores, scores[i])
                and c.reveal_fraction == float(frac[i])):
            fail(f"phase 10f local: rid {c.rid} differs from the routed "
                 "step")
    s = loc.metrics.summary()
    print(f"phase 10f engine stage1='local': {len(comps)} requests in "
          f"{secs * 1e3:.1f} ms; every completion == the routed step bit "
          f"for bit; overlap@{K} with phase 4 dense "
          f"{overlap(gids, dense4[1]):.4f}; routed_skew "
          f"{s['routed_skew']:.4f}; compiles_after_warmup "
          f"{s['compiles_after_warmup']}; launches {counts}", flush=True)
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s; elapsed "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    return served


def tuning_and_audit(dev, index, ds, cand, smi, t_start):
    """11. Launch-shape tuning and the serving-contract audit on the card,
    on phase 4's corpus, queries and stage-1 candidates with phase 9's
    ``EngineConfig`` (and phase 10's S = 4 mesh).

    (a) ``ops.autotune_op`` at each serving bucket, f32 and int8:
        ``maxsim_batch`` (B = 16, N = 64, T = 32) and ``fused_reveal`` /
        ``gather_maxsim`` (128 frontier rows, G = 8, D = 4,096, TQ = 512):
        each candidate's device ms (CUDA events behind a spin kernel, best
        of 10), the winner and the default's ms, in two passes in turns;
    (b) ``EngineConfig(autotune=True, tuning_table=<temp file>)``: the
        engine times its own buckets, serves phase 9's 48 requests, and
        every completion equals an untuned engine's bit for bit; a second
        engine loads the table and times 0 buckets;
    (c) ``audit=True`` engines pass their warmup: f32 (the untuned engine
        of (b)), int8, and the S = 4 mesh with ``stage1="host"`` and
        ``"local"``; each bucket's report is printed (host reads per site
        and per trip, logical cross-shard bytes against the budget, peak
        against the bound);
    (d) a step that copies its output to the host (``.cpu()``) fails the
        audit with ``hlo-host-sync``.

    Returns the kernels' launches in (b)'s served run."""
    import collections
    import os
    import tempfile

    from repro_torch.analysis.audit import AuditError
    from repro_torch.kernels import _build, ops, tuning
    from repro_torch.kernels.gather_maxsim import reveal_block_l
    from repro_torch.serve import EngineConfig, Request, RetrievalEngine

    t_phase = time.perf_counter()
    nq, T, M = ds.queries.shape
    L = index.doc_embs.shape[1]
    served = collections.Counter()
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

    def sync_dev():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # (a) autotune_op per serving bucket ---------------------------------
    rows = nq * 2 * (cfg.block_docs // 2)
    reveal = dict(B=rows, G=cfg.block_tokens, L=L, M=M,
                  D=nq * MAX_CANDIDATES, TQ=nq * T)
    tuned = {}
    tuning.clear()
    for rnd in (1, 2):                    # two passes in turns: stability
        for fmt, f in (("f32", {}), ("int8", {"FMT": 2})):
            for op, dims in (("maxsim_batch",
                              dict(B=nq, N=64, T=T, L=L, M=M)),
                             ("fused_reveal", reveal),
                             ("gather_maxsim", reveal)):
                dims = dict(dims, **f)
                best, times = ops.autotune_op(op, dims, repeats=10,
                                              device=dev)
                ms = {json.loads(k)[next(iter(json.loads(k)))]: v * 1e3
                      for k, v in times.items()}
                knob = next(iter(tuning.DEFAULTS[op]))
                default = tuning.DEFAULTS[op][knob]
                if knob == "block_l":      # 0: the rule by frontier rows
                    default = reveal_block_l(dims["B"], default)
                if dev.type == "cuda" and (tuning.lookup(op, dims) != best
                                           or not ms):
                    fail(f"phase 11a {op} {fmt}: winner {best} not "
                         "recorded")
                row = tuned.setdefault((op, fmt), dict(default=default))
                row[f"ms{rnd}"], row[f"winner{rnd}"] = ms, best.get(knob)
                print(f"phase 11a pass {rnd} {op} {fmt} {dims}: {knob} "
                      f"candidates device ms {ms}; winner {best}; default "
                      f"({knob} {default}) "
                      f"{ms.get(default, float('nan')):.4f} ms; {smi}",
                      flush=True)
    same = [k for k, v in tuned.items() if v["winner1"] == v["winner2"]]
    print(f"phase 11a: the two passes pick the same winner in {len(same)} "
          f"of {len(tuned)} buckets", flush=True)
    summary = {f"{o} {f}": v for (o, f), v in tuned.items()}
    print(f"phase 11a json {json.dumps(summary)}", flush=True)
    tuning.clear()

    # (b) an autotuned engine == an untuned one; the table reloads --------
    def serve(eng, reqs, tally=False):
        _build.reset_launches()
        sync_dev()
        t = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        done = eng.drain()
        sync_dev()
        secs = time.perf_counter() - t
        counts = {k: v for k, v in _build.LAUNCHES.items() if v}
        if tally:
            served.update(counts)
        got = {c.rid: c for c in done}
        if len(got) != len(done) or len(done) != len(reqs) \
                or eng.metrics.compiles_after_warmup:
            fail(f"phase 11: {len(done)} completions for {len(reqs)}, "
                 f"{eng.metrics.compiles_after_warmup} builds after warmup")
        return got, secs, counts

    def report(label, eng):
        for key, r in sorted(eng.audit_reports.items()):
            spec = eng._audit_spec(key)
            reads = sum(r.host_reads.values())
            per = f"{reads / r.trips:.3f}" if r.trips else "-"
            print(f"phase 11c {label} {key}: host reads {r.host_reads} over "
                  f"{r.trips} trips ({per} a trip), collective "
                  f"{r.collective_total} B of budget "
                  f"{spec.collective_budget}, peak {r.peak_bytes:.0f} B of "
                  f"bound {spec.peak_bytes} ({r.ops} ops)", flush=True)

    t = time.perf_counter()
    plain = RetrievalEngine(index.doc_embs, index.doc_mask,
                            dataclasses.replace(cfg, audit=True), device=dev)
    plain.warmup()
    print(f"phase 11c f32 engine built, warmed and audited in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    report("f32", plain)
    want, _, _ = serve(plain, requests)
    table = os.path.join(tempfile.mkdtemp(), "tuning.json")
    t = time.perf_counter()
    eng = RetrievalEngine(index.doc_embs, index.doc_mask,
                          dataclasses.replace(cfg, autotune=True,
                                              tuning_table=table),
                          device=dev)
    eng.warmup()
    m = eng.metrics
    entries = tuning.table_json()
    print(f"phase 11b autotuned engine built in {time.perf_counter() - t:.1f}"
          f" s: {m.autotune_buckets} buckets timed in "
          f"{m.autotune_s * 1e3:.1f} ms, table {entries}", flush=True)
    got, secs, counts = serve(eng, requests, tally=True)
    bad = [r for r in want if not (
        np.array_equal(got[r].topk_ids, want[r].topk_ids)
        and np.array_equal(got[r].topk_scores, want[r].topk_scores)
        and got[r].reveal_fraction == want[r].reveal_fraction)]
    if bad or not (counts.get("maxsim") and counts.get("fused_reveal")):
        fail(f"phase 11b: rids {bad} differ from the untuned engine; "
             f"launches {counts}")
    if dev.type == "cuda" and m.autotune_buckets != len(eng._autotune_dims()):
        fail(f"phase 11b: {m.autotune_buckets} buckets timed")
    tuning.clear()
    again = RetrievalEngine(index.doc_embs, index.doc_mask,
                            dataclasses.replace(cfg, autotune=True,
                                                tuning_table=table),
                            device=dev)
    again.warmup()
    rows_saved = len(json.load(open(table)))
    # (On the CPU the ops ignore launch shapes and nothing is recorded.)
    if dev.type == "cuda" and (
            again.metrics.autotune_buckets or rows_saved == 0
            or again.metrics.tuning_entries_loaded != rows_saved):
        fail(f"phase 11b: the second engine timed "
             f"{again.metrics.autotune_buckets} buckets and loaded "
             f"{again.metrics.tuning_entries_loaded} of {rows_saved} rows")
    print(f"phase 11b: {len(got)} requests in {secs * 1e3:.1f} ms, every "
          f"completion == the untuned engine's bit for bit; launches "
          f"{counts}; a second engine loaded {rows_saved} rows and timed 0 "
          f"buckets; {smi}", flush=True)
    tuning.clear()

    # (c) audit=True engines: int8, the S = 4 mesh, routed ----------------
    axes = (("data", 2), ("model", 2))
    for label, kw in (("int8", dict(corpus_format="int8")),
                      ("mesh S=4", dict(mesh_axes=axes)),
                      ("mesh S=4 local", dict(mesh_axes=axes,
                                              stage1="local"))):
        t = time.perf_counter()
        e = RetrievalEngine(index.doc_embs, index.doc_mask,
                            dataclasses.replace(cfg, audit=True, **kw),
                            device=dev)
        e.warmup()
        print(f"phase 11c {label} engine built, warmed and audited in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        report(label, e)
        meshed = {k: r for k, r in e.audit_reports.items()
                  if k[0] in ("step", "routed") and "mesh_axes" in kw}
        if "mesh_axes" in kw and not all(
                0 < r.collective_total <= e._audit_spec(k).collective_budget
                for k, r in meshed.items()):
            fail(f"phase 11c {label}: cross-shard bytes outside (0, budget]")
        del e

    # (d) a host copy inside a step fails the audit -----------------------
    key = ("step", "dense", T, 64)
    real = plain._exec[key]

    def leaky(*args):
        out = real(*args)
        out[0].cpu()
        return out
    plain._exec[key] = leaky
    try:
        plain.audit()
    except AuditError as err:
        if err.rule != "hlo-host-sync" or repr(key) not in str(err):
            fail(f"phase 11d: wrong audit failure {err}")
        print(f"phase 11d: a step with .cpu() fails the audit: "
              f"{str(err).splitlines()[0]} | {err.lines[0]}", flush=True)
    else:
        if dev.type == "cuda":
            fail("phase 11d: a .cpu() inside a step passed the audit")
    plain._exec[key] = real
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s; elapsed "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    return served


def lm_serving(dev, profiled_line, smi, t_start):
    """12. LM serving and the late-interaction encoder (``repro_torch.models``,
    ``repro_torch.serve.lm``: plain PyTorch; the JAX package runs these in
    ``jnp``, no Pallas kernel), bf16 weights unless stated, every weight
    drawn on ``dev`` from a seeded ``torch.Generator``.

    (a) Qwen2.5-3B at full width and depth (36 layers, 3.40 B parameters,
        the head untied as in JAX): ``generate`` at B = 8, a 512-token
        prompt and 32 new tokens (float32 cache, ``generate``'s default);
        prefill ms and decode ms per step (CUDA events), tokens/s (host
        clock around ``generate``), peak memory, and the byte and flop
        bounds beside them; one profiled prefill and decode step (device
        busy time and idle share).
    (b) Consistency in float32 weights and cache at B = 2: Qwen2.5-3B at
        full depth (a 64-token prompt), and gemma2-27b at full width with
        depth cut to one (local, global) pair (B = 1, a 4,100-token prompt,
        so the window-4,096 ring wraps during decode); 4 decode steps each,
        each step's logits held to ``forward_train``'s last row of the grown
        sequence within LM_ATOL, and its argmax to that row's wherever the
        row's top-2 gap exceeds 2 * LM_ATOL.
    (c) The card against the CPU: Qwen2.5-3B at full width, 2 layers,
        float32, the same weights on both: ``encode_tokens`` equal within
        ENC_ATOL, masked rows exactly 0.
    (d) Tokens to top-K: (a)'s model with an LI head encodes 2,048 docs
        (random ids from seed 0, lengths 32-128, padded to L = 128) and 16
        queries (T = 32); a float32 ``TokenIndex`` of the embeddings serves
        dense, bandit fused and bandit chain (``BanditConfig(k=5)``, k' =
        10, 256 candidates). Chain == fused (ids, reveal fractions) exactly;
        overlap@5 against dense, reveal fraction and encode rates reported
        without a gate (random-weight embeddings are not the paper's
        distribution, so its 0.9 bar does not apply).

    Returns the kernel launches of (d)'s serving calls."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.configs.base import BanditConfig
    from repro_torch.core.metrics import overlap_at_k
    from repro_torch.kernels import _build
    from repro_torch.models.colbert import encode_tokens, init_li_head
    from repro_torch.models.transformer import (DecoderLM, forward_prefill,
                                                forward_train, init_lm)
    from repro_torch.retrieval.index import TokenIndex
    from repro_torch.retrieval.pipeline import serve_queries
    from repro_torch.serve import generate, serve_step

    t_phase = time.perf_counter()
    resident = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    bw, _ = peaks(torch.cuda.get_device_name(0))
    bf16_peak = 989e12        # dense bf16 tensor-core peak, H100 SXM
    gen = torch.Generator(device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def event_ms(fn):
        """Device-ordered ms of one call of fn (CUDA events), and its
        result."""
        if dev.type != "cuda":
            t = time.perf_counter()
            out = fn()
            return (time.perf_counter() - t) * 1e3, out
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), out

    # (a) Qwen2.5-3B, bf16 ----------------------------------------------------
    cfg = get_config("qwen2.5-3b")
    t = time.perf_counter()
    model = init_lm(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"phase 12a qwen2.5-3b: {n_params} parameters (the config's "
          f"analytic count {cfg.param_count()} takes the final norm twice), "
          f"{w_bytes / 1e9:.2f} GB bf16, drawn on {dev} in "
          f"{time.perf_counter() - t:.1f} s [{smi}]", flush=True)
    B, S, NEW = 8, 512, 32
    prompt = torch.randint(0, cfg.vocab, (B, S), generator=gen.manual_seed(1),
                           device=dev, dtype=torch.int32)
    generate(model, cfg, prompt[:, :16], max_new_tokens=2)     # warm-up
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync()
    t = time.perf_counter()
    out = generate(model, cfg, prompt, max_new_tokens=NEW)
    sync()
    gen_s = time.perf_counter() - t
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0)
    if out.shape != (B, S + NEW) or not torch.equal(out[:, :S], prompt) or \
            int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
        fail(f"phase 12a: generate gave {tuple(out.shape)}, ids "
             f"{int(out.min())}..{int(out.max())}")
    with torch.no_grad():
        pre_ms, (logits, cache) = event_ms(
            lambda: forward_prefill(model, cfg, prompt, S + NEW,
                                    cache_dtype=torch.float32))
        if not torch.isfinite(logits).all():
            fail("phase 12a: prefill logits are not finite")
        tok = torch.argmax(logits, -1).to(torch.int32)
        step_ms = []
        for step in range(NEW):
            ms, (logits, cache) = event_ms(
                lambda: serve_step(model, cfg, tok, S + step, cache))
            step_ms.append(ms)
            tok = torch.argmax(logits, -1).to(torch.int32)
    if not torch.isfinite(logits).all():
        fail("phase 12a: decode logits are not finite")
    cache_bytes = sum(st.k.numel() * st.k.element_size() * 2
                      for st in cache.values())
    body = w_bytes - 2 * cfg.vocab * cfg.d_model * 2   # blocks only
    dec_bytes = w_bytes - (cfg.vocab - B) * cfg.d_model * 2 + cache_bytes
    dec_flops = 2 * (body // 2 + cfg.d_model * cfg.vocab) * B
    pre_flops = (2 * (body // 2) * B * S + 2 * cfg.d_model * cfg.vocab * B
                 + 4 * cfg.n_layers * B * S * S * cfg.q_dim // 2)
    bound = {k: (max(nb / bw, fl / bf16_peak) * 1e3,
                 "bytes" if nb / bw >= fl / bf16_peak else "operations")
             for k, (nb, fl) in (("prefill", (w_bytes, pre_flops)),
                                 ("decode", (dec_bytes, dec_flops)))}
    dec_med = statistics.median(step_ms)
    print(f"phase 12a generate B={B} prompt={S} new={NEW}: "
          f"{gen_s * 1e3:.1f} ms end to end = {B * NEW / gen_s:.1f} new "
          f"tokens/s; prefill {pre_ms:.2f} ms (bound {bound['prefill'][0]:.2f}"
          f" ms by {bound['prefill'][1]}); decode median {dec_med:.3f} ms per "
          f"step, min {min(step_ms):.3f}, max {max(step_ms):.3f} (bound "
          f"{bound['decode'][0]:.3f} ms by {bound['decode'][1]}: weights "
          f"{w_bytes / 1e9:.2f} GB / {bw / 1e12} TB/s = "
          f"{w_bytes / bw * 1e3:.3f} ms); {B / dec_med * 1e3:.1f} tokens/s "
          f"decoding; peak memory {(peak - resident) / 1e9:.2f} GB above the "
          f"{resident / 1e9:.2f} GB earlier phases left resident [{smi}]",
          flush=True)
    with torch.no_grad():
        print(profiled_line("phase 12a prefill", lambda: forward_prefill(
            model, cfg, prompt, S + NEW, cache_dtype=torch.float32), pre_ms),
            f"[{smi}]", flush=True)
        # The last step again: it rewrites its own slot.
        print(profiled_line("phase 12a decode step", lambda: serve_step(
            model, cfg, tok, S + NEW - 1, cache), dec_med), f"[{smi}]",
            flush=True)

    # (d) tokens to top-K, on (a)'s model -------------------------------------
    head = init_li_head(cfg, seed=2, dtype=torch.bfloat16, device=dev)
    n_docs, L, nq, T, chunk = 2048, 128, 16, 32, 256
    g0 = torch.Generator(device="cpu").manual_seed(0)
    doc_ids = torch.randint(0, cfg.vocab, (n_docs, L), generator=g0)
    lens = torch.randint(32, L + 1, (n_docs,), generator=g0)
    doc_mask = torch.arange(L)[None, :] < lens[:, None]
    doc_ids[~doc_mask] = 0
    q_ids = torch.randint(0, cfg.vocab, (nq, T), generator=g0)
    with torch.no_grad():
        sync()
        t = time.perf_counter()
        embs = torch.cat([encode_tokens(model, head, cfg,
                                        doc_ids[i:i + chunk],
                                        doc_mask[i:i + chunk])[0]
                          for i in range(0, n_docs, chunk)])
        sync()
        docs_s = time.perf_counter() - t
        t = time.perf_counter()
        q_emb = encode_tokens(model, head, cfg, q_ids,
                              torch.ones((nq, T), dtype=torch.bool))[0]
        sync()
        q_s = time.perf_counter() - t
    del model
    if embs.shape != (n_docs, L, cfg.li_dim) or not torch.isfinite(
            embs).all() or embs[~doc_mask.to(dev)].any():
        fail("phase 12d: malformed doc embeddings")
    index = TokenIndex(doc_embs=embs.float().contiguous(),
                       doc_mask=doc_mask.to(dev),
                       doc_lens=lens.to(device=dev, dtype=torch.int64))
    queries = q_emb.float().contiguous()
    print(f"phase 12d encode: {n_docs} docs (L={L}, {int(lens.sum())} valid "
          f"tokens) in {docs_s * 1e3:.1f} ms = {n_docs / docs_s:.1f} docs/s; "
          f"{nq} queries (T={T}) in {q_s * 1e3:.1f} ms = {nq / q_s:.1f} "
          f"queries/s [{smi}]", flush=True)
    calls = {"dense": dict(flavor="dense"),
             "fused": dict(flavor="bandit", engine="pooled"),
             "chain": dict(flavor="bandit", engine="pooled_chain")}
    res, launches = {}, {}
    for label, kw in calls.items():
        _build.reset_launches()
        sync()
        t = time.perf_counter()
        res[label] = serve_queries(index, queries, k=K, kprime=10,
                                   max_candidates=MAX_CANDIDATES,
                                   bandit=BanditConfig(k=K), seed=SEED,
                                   device=dev, **kw)
        sync()
        ms = (time.perf_counter() - t) * 1e3
        launches[label] = dict(_build.LAUNCHES)
        r = res[label]
        print(f"phase 12d serve {label}: {ms:.1f} ms per batch of {nq}; "
              f"launches {launches[label]}; mean reveal fraction "
              f"{r.reveal_fraction.mean():.4f}; stats {r.stats.tolist()} "
              f"[{smi}]", flush=True)
        if r.topk_ids.shape != (nq, K) or not np.isfinite(
                r.topk_scores[r.topk_ids >= 0]).all():
            fail(f"phase 12d {label}: malformed result")
    for label, kname in (("dense", "maxsim"), ("fused", "fused_reveal"),
                         ("chain", "gather_maxsim")):
        if not launches[label][kname]:
            fail(f"phase 12d {label}: the {kname} kernel was never launched")
    if not (np.array_equal(res["fused"].topk_ids, res["chain"].topk_ids)
            and np.array_equal(res["fused"].reveal_fraction,
                               res["chain"].reveal_fraction)):
        fail("phase 12d: chain and fused differ in ids or reveal fractions")
    ov = float(overlap_at_k(torch.as_tensor(res["fused"].topk_ids),
                            torch.as_tensor(res["dense"].topk_ids)).mean())
    print(f"phase 12d: chain == fused (ids, reveal fractions); overlap@{K} "
          f"of bandit with dense {ov:.4f} (reported, no gate); mean reveal "
          f"fraction {res['fused'].reveal_fraction.mean():.4f} [{smi}]",
          flush=True)
    del index, embs, queries
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (b) consistency, float32 ------------------------------------------------
    def consistency(label, cfg_b, Bb, Sb):
        """Prefill Sb tokens, 4 decode steps; each step against
        forward_train on the grown sequence."""
        model_b = init_lm(cfg_b, seed=3, dtype=torch.float32, device=dev)
        toks = torch.randint(0, cfg_b.vocab, (Bb, Sb),
                             generator=gen.manual_seed(4), device=dev)
        err, flips, checked = 0.0, 0, 0
        with torch.no_grad():
            last, cache_b = forward_prefill(model_b, cfg_b, toks, Sb + 4,
                                            cache_dtype=torch.float32)
            seq = toks
            cur = torch.argmax(last, -1)
            for step in range(4):
                dec, cache_b = serve_step(model_b, cfg_b, cur, Sb + step,
                                          cache_b)
                seq = torch.cat([seq, cur[:, None]], dim=1)
                ref = forward_train(model_b, cfg_b, seq)[:, -1]
                err = max(err, float((dec - ref).abs().max()))
                top2 = torch.topk(ref, 2, dim=-1).values
                clear = (top2[:, 0] - top2[:, 1]) > 2 * LM_ATOL
                same = torch.argmax(dec, -1) == torch.argmax(ref, -1)
                checked += int(clear.sum())
                flips += int((clear & ~same).sum())
                cur = torch.argmax(dec, -1)
        if err > LM_ATOL or flips:
            fail(f"phase 12b {label}: max |decode - forward_train| {err:.3g}"
                 f" (atol {LM_ATOL}), {flips} greedy ids differ")
        print(f"phase 12b {label} f32 B={Bb} prompt={Sb}: 4 decode steps "
              f"== forward_train's last row, max_abs_err {err:.3g} (atol "
              f"{LM_ATOL}); greedy ids equal on {checked} of {4 * Bb} steps "
              f"with a top-2 gap > {2 * LM_ATOL} [{smi}]", flush=True)

    consistency(f"qwen2.5-3b {cfg.n_layers} layers", cfg, 2, 64)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gemma = get_config("gemma2-27b")
    gemma2 = dataclasses.replace(gemma, n_layers=2)    # one (local, global)
    consistency(f"gemma2-27b full width, 2 of {gemma.n_layers} layers, "
                f"window {gemma.sliding_window}", gemma2, 1,
                gemma.sliding_window + 4)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (c) the card against the CPU, float32 -----------------------------------
    cfg_c = dataclasses.replace(cfg, n_layers=2)
    model_c = init_lm(cfg_c, seed=5, dtype=torch.float32, device=dev)
    head_c = init_li_head(cfg_c, seed=6, dtype=torch.float32, device=dev)
    cpu_model = DecoderLM(cfg_c, torch.float32, "cpu")
    cpu_model.load_state_dict(model_c.state_dict())
    cpu_head = copy.deepcopy(head_c).to("cpu")
    g5 = torch.Generator(device="cpu").manual_seed(5)
    toks = torch.randint(0, cfg_c.vocab, (2, 64), generator=g5)
    mask = torch.arange(64)[None, :] < torch.tensor([[64], [40]])
    with torch.no_grad():
        on_card = encode_tokens(model_c, head_c, cfg_c, toks, mask)[0].cpu()
        on_cpu = encode_tokens(cpu_model, cpu_head, cfg_c, toks, mask)[0]
    err = float((on_card - on_cpu).abs().max())
    if err > ENC_ATOL or on_card[~mask].any() or on_cpu[~mask].any():
        fail(f"phase 12c: card vs CPU max_abs_err {err:.3g} (atol "
             f"{ENC_ATOL}) or a masked row is not 0")
    print(f"phase 12c encode_tokens qwen2.5-3b full width, 2 layers, f32: "
          f"card == CPU within atol {ENC_ATOL} (max_abs_err {err:.3g}); "
          f"masked rows 0 [{smi}]", flush=True)
    del model_c, head_c
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s; elapsed "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    return {kname: sum(run[kname] for run in launches.values())
            for kname in launches["dense"]}


def moe_and_recsys(dev, profiled_line, smi, t_start):
    """13. The MoE backbones (``repro_torch.models.moe``), the recsys zoo
    (``models/recsys.py``) and the generalized Col-Bandit
    (``core/generalized.py``): plain PyTorch around the ported kernels,
    every weight drawn on ``dev`` from a seeded ``torch.Generator``.

    (a) Moonlight-16B-A3B at full width and depth (48 layers, 64 experts
        top-6, 28.06 B parameters) in bf16: ``generate`` at B = 8, a
        512-token prompt and 32 new tokens (float32 cache); prefill and
        decode ms (CUDA events) beside their bounds, tokens/s, peak memory,
        one profiled prefill and decode step, and the distinct experts each
        layer's decode step routes to. Decode keeps the reference's
        ``no_drop`` formulation, whose expert products read every expert.
    (b) Consistency in float32 with the capacity factor n_experts / top_k,
        so the capacity is S and no token is dropped (decode's ``no_drop``
        then computes what ``forward_train`` does): Moonlight at full width,
        2 layers, B = 2, a 64-token prompt; Mixtral 8x22B at full width, 2
        of 56 layers, B = 1, a 4,100-token prompt (the window-4,096 ring
        wraps during decode). 4 decode steps each, held to
        ``forward_train``'s last row within LM_ATOL and its argmax where
        the row's top-2 gap exceeds 2 * LM_ATOL, under the routing rule.
    (c) The card against the CPU: Moonlight at full width, 2 layers,
        float32, the same weights on both: ``encode_tokens`` within
        ENC_ATOL under the routing rule, masked rows exactly 0.
    (d) Tokens to top-K through the MoE encoder: (a)'s model with an LI
        head encodes 2,048 docs (random ids, lengths 32-128, L = 128) and
        16 queries (T = 32); a float32 ``TokenIndex`` serves dense, bandit
        fused and bandit chain. Chain == fused exactly; overlap@5 against
        dense and the reveal fraction reported without a gate.
    (e) Recsys at each config's full width, float32 tables on the card:
        ``serve_p99`` (the forward at batch 512) and ``retrieval_cand`` (1
        query x 1,000,000 candidates through ``*_score_candidates``), ms
        per call (CUDA events); the card equals the CPU on the forward and
        on the first 4,096 candidates within atol 1e-5, and FM's
        components sum to its scores.
    (f) ``topk_bandit_generalized`` on the card over
        ``benchmarks/generalized_recsys.py``'s grid (4,096 candidates, 16
        fields, dim 10, k = 10, alpha_ef 0.1 / 0.3 / 1.0, seeds 0-3):
        coverage and overlap@10 against ``exact_topk``, and whether the
        card's ids equal a CPU run's; then once on (e)'s full-width FM
        components (4,096 candidates x 39 components).

    The routing rule: two computations may route a token differently only
    where its top-k gap is below MOE_TIE in either; every logit row or
    embedding of that batch row from that token on is left out of the
    comparison, and at most one of (b)'s four decode steps may be skipped.

    Returns the kernel launches of (d)'s serving calls."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import BanditConfig
    from repro_torch.core.baselines import exact_topk
    from repro_torch.core.generalized import (fm_pair_components,
                                              topk_bandit_generalized)
    from repro_torch.core.metrics import overlap_at_k
    from repro_torch.kernels import _build
    from repro_torch.models import recsys as R
    from repro_torch.models.colbert import encode_tokens, init_li_head
    from repro_torch.models.moe import (MoE, compare_routing,
                                        record_routing, routing_by_layer)
    from repro_torch.models.transformer import (DecoderLM, forward_prefill,
                                                forward_train, init_lm)
    from repro_torch.retrieval.index import TokenIndex
    from repro_torch.retrieval.pipeline import serve_queries
    from repro_torch.serve import generate, serve_step

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    if on_card:
        free, total = torch.cuda.mem_get_info()
        held = torch.cuda.memory_allocated()
        print(f"phase 13: torch.cuda.mem_get_info() free {free / 1e9:.2f} "
              f"GB of {total / 1e9:.2f} GB; {held / 1e9:.2f} GB allocated by "
              f"earlier phases [{smi}]", flush=True)
    resident = torch.cuda.memory_allocated() if on_card else 0
    bw, _ = peaks(torch.cuda.get_device_name(0))
    bf16_peak = 989e12        # dense bf16 tensor-core peak, H100 SXM
    gen = torch.Generator(device=dev)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def free_card():
        if on_card:
            torch.cuda.empty_cache()

    def event_ms(fn):
        """Device-ordered ms of one call of fn (CUDA events), and its
        result."""
        if not on_card:
            t = time.perf_counter()
            out = fn()
            return (time.perf_counter() - t) * 1e3, out
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), out

    def expert_bytes(model):
        return sum(w.numel() * w.element_size() for m in model.modules()
                   if isinstance(m, MoE)
                   for w in (m.w_gate, m.w_up, m.w_down))

    # (a) Moonlight-16B-A3B, bf16, full width and depth -----------------------
    cfg = get_config("moonshot-v1-16b-a3b")
    t = time.perf_counter()
    model = init_lm(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    e_bytes = expert_bytes(model)
    print(f"phase 13a {cfg.name}: {cfg.n_layers} layers (no depth cut), "
          f"{n_params} parameters (the config's analytic count "
          f"{cfg.param_count()} takes the final norm twice; "
          f"{cfg.active_param_count()} active a token), {w_bytes / 1e9:.2f} "
          f"GB bf16 of which experts {e_bytes / 1e9:.2f} GB, drawn on {dev} "
          f"in {time.perf_counter() - t:.1f} s [{smi}]", flush=True)
    B, S, NEW = 8, 512, 32
    prompt = torch.randint(0, cfg.vocab, (B, S), generator=gen.manual_seed(1),
                           device=dev, dtype=torch.int32)
    generate(model, cfg, prompt[:, :16], max_new_tokens=2)     # warm-up
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sync()
    t = time.perf_counter()
    out = generate(model, cfg, prompt, max_new_tokens=NEW)
    sync()
    gen_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if out.shape != (B, S + NEW) or not torch.equal(out[:, :S], prompt) or \
            int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
        fail(f"phase 13a: generate gave {tuple(out.shape)}, ids "
             f"{int(out.min())}..{int(out.max())}")
    with torch.no_grad():
        pre_ms, (logits, cache) = event_ms(
            lambda: forward_prefill(model, cfg, prompt, S + NEW,
                                    cache_dtype=torch.float32))
        if not torch.isfinite(logits).all():
            fail("phase 13a: prefill logits are not finite")
        tok = torch.argmax(logits, -1).to(torch.int32)
        step_ms = []
        for step in range(NEW):
            ms, (logits, cache) = event_ms(
                lambda: serve_step(model, cfg, tok, S + step, cache))
            step_ms.append(ms)
            tok = torch.argmax(logits, -1).to(torch.int32)
        if not torch.isfinite(logits).all():
            fail("phase 13a: decode logits are not finite")
        with record_routing(model) as log:    # the last step again
            serve_step(model, cfg, tok, S + NEW - 1, cache)
    distinct = [int(torch.unique(r.routing.top_idx).numel()) for r in log]
    cache_bytes = sum(st.k.numel() * st.k.element_size() * 2
                      for st in cache.values())
    d, e_ff = cfg.d_model, cfg.moe_d_ff
    per_expert = 3 * d * e_ff * 2                        # bf16 bytes
    non_expert = w_bytes - e_bytes - (cfg.vocab - B) * d * 2
    dec_bytes = non_expert + sum(distinct) * per_expert + cache_bytes
    body_active = cfg.active_param_count() - 2 * cfg.vocab * d - d
    dec_flops = 2 * (body_active + d * cfg.vocab) * B
    pre_flops = (2 * body_active * B * S + 2 * d * cfg.vocab * B
                 + 4 * cfg.n_layers * B * S * S * cfg.q_dim // 2)
    bound = {k: (max(nb / bw, fl / bf16_peak) * 1e3,
                 "bytes" if nb / bw >= fl / bf16_peak else "operations")
             for k, (nb, fl) in (("prefill", (w_bytes, pre_flops)),
                                 ("decode", (dec_bytes, dec_flops)))}
    all_experts_ms = e_bytes / bw * 1e3
    dec_med = statistics.median(step_ms)
    print(f"phase 13a generate B={B} prompt={S} new={NEW}: "
          f"{gen_s * 1e3:.1f} ms end to end = {B * NEW / gen_s:.1f} new "
          f"tokens/s; prefill {pre_ms:.2f} ms (bound {bound['prefill'][0]:.2f}"
          f" ms by {bound['prefill'][1]}); decode median {dec_med:.3f} ms per "
          f"step, min {min(step_ms):.3f}, max {max(step_ms):.3f} (bound "
          f"{bound['decode'][0]:.3f} ms by {bound['decode'][1]}: non-expert "
          f"weights {non_expert / 1e9:.3f} GB + {sum(distinct)} routed "
          f"experts {sum(distinct) * per_expert / 1e9:.3f} GB + cache "
          f"{cache_bytes / 1e9:.3f} GB at {bw / 1e12} TB/s; the reference's "
          f"no_drop expert products read all {cfg.n_experts} experts a "
          f"layer, {e_bytes / 1e9:.2f} GB = {all_experts_ms:.3f} ms alone); "
          f"{B / dec_med * 1e3:.1f} tokens/s decoding; peak memory "
          f"{(peak - resident) / 1e9:.2f} GB above the {resident / 1e9:.2f} "
          f"GB earlier phases left resident [{smi}]", flush=True)
    print(f"phase 13a decode step: distinct experts routed per layer "
          f"(B={B} tokens x top-{cfg.experts_top_k}) min {min(distinct)}, "
          f"median {statistics.median(distinct)}, max {max(distinct)}: "
          f"{distinct}", flush=True)
    with torch.no_grad():
        print(profiled_line("phase 13a prefill", lambda: forward_prefill(
            model, cfg, prompt, S + NEW, cache_dtype=torch.float32), pre_ms),
            f"[{smi}]", flush=True)
        print(profiled_line("phase 13a decode step", lambda: serve_step(
            model, cfg, tok, S + NEW - 1, cache), dec_med), f"[{smi}]",
            flush=True)
    del cache, logits

    # (d) tokens to top-K through the MoE encoder, on (a)'s model ------------
    head = init_li_head(cfg, seed=2, dtype=torch.bfloat16, device=dev)
    n_docs, L, nq, T, chunk = 2048, 128, 16, 32, 128
    g0 = torch.Generator(device="cpu").manual_seed(0)
    doc_ids = torch.randint(0, cfg.vocab, (n_docs, L), generator=g0)
    lens = torch.randint(32, L + 1, (n_docs,), generator=g0)
    doc_mask = torch.arange(L)[None, :] < lens[:, None]
    doc_ids[~doc_mask] = 0
    q_ids = torch.randint(0, cfg.vocab, (nq, T), generator=g0)
    with torch.no_grad():
        sync()
        t = time.perf_counter()
        embs = torch.cat([encode_tokens(model, head, cfg,
                                        doc_ids[i:i + chunk],
                                        doc_mask[i:i + chunk])[0]
                          for i in range(0, n_docs, chunk)])
        sync()
        docs_s = time.perf_counter() - t
        t = time.perf_counter()
        q_emb = encode_tokens(model, head, cfg, q_ids,
                              torch.ones((nq, T), dtype=torch.bool))[0]
        sync()
        q_s = time.perf_counter() - t
    del model, head
    free_card()
    if embs.shape != (n_docs, L, cfg.li_dim) or not torch.isfinite(
            embs).all() or embs[~doc_mask.to(dev)].any():
        fail("phase 13d: malformed doc embeddings")
    index = TokenIndex(doc_embs=embs.float().contiguous(),
                       doc_mask=doc_mask.to(dev),
                       doc_lens=lens.to(device=dev, dtype=torch.int64))
    queries = q_emb.float().contiguous()
    del embs, q_emb
    print(f"phase 13d encode ({cfg.name}, {cfg.n_layers} layers, bf16): "
          f"{n_docs} docs (L={L}, {int(lens.sum())} valid tokens, pads "
          f"routed) in {docs_s * 1e3:.1f} ms = {n_docs / docs_s:.1f} docs/s;"
          f" {nq} queries (T={T}) in {q_s * 1e3:.1f} ms = "
          f"{nq / q_s:.1f} queries/s [{smi}]", flush=True)
    calls = {"dense": dict(flavor="dense"),
             "fused": dict(flavor="bandit", engine="pooled"),
             "chain": dict(flavor="bandit", engine="pooled_chain")}
    res, launches = {}, {}
    for label, kw in calls.items():
        _build.reset_launches()
        sync()
        t = time.perf_counter()
        res[label] = serve_queries(index, queries, k=K, kprime=10,
                                   max_candidates=MAX_CANDIDATES,
                                   bandit=BanditConfig(k=K), seed=SEED,
                                   device=dev, **kw)
        sync()
        ms = (time.perf_counter() - t) * 1e3
        launches[label] = dict(_build.LAUNCHES)
        r = res[label]
        print(f"phase 13d serve {label}: {ms:.1f} ms per batch of {nq}; "
              f"launches {launches[label]}; mean reveal fraction "
              f"{r.reveal_fraction.mean():.4f}; stats {r.stats.tolist()} "
              f"[{smi}]", flush=True)
        if r.topk_ids.shape != (nq, K) or not np.isfinite(
                r.topk_scores[r.topk_ids >= 0]).all():
            fail(f"phase 13d {label}: malformed result")
    for label, kname in (("dense", "maxsim"), ("fused", "fused_reveal"),
                         ("chain", "gather_maxsim")):
        if not launches[label][kname]:
            fail(f"phase 13d {label}: the {kname} kernel was never launched")
    if not (np.array_equal(res["fused"].topk_ids, res["chain"].topk_ids)
            and np.array_equal(res["fused"].reveal_fraction,
                               res["chain"].reveal_fraction)):
        fail("phase 13d: chain and fused differ in ids or reveal fractions")
    ov = float(overlap_at_k(torch.as_tensor(res["fused"].topk_ids),
                            torch.as_tensor(res["dense"].topk_ids)).mean())
    print(f"phase 13d: chain == fused (ids, reveal fractions); overlap@{K} "
          f"of bandit with dense {ov:.4f} (reported, no gate); mean reveal "
          f"fraction {res['fused'].reveal_fraction.mean():.4f} [{smi}]",
          flush=True)
    del index, queries
    free_card()

    # (b) consistency, float32, no token dropped ------------------------------
    def consistency(label, cfg_b, Bb, Sb):
        """Prefill Sb tokens, 4 decode steps; each step against
        forward_train on the grown sequence, under the routing rule."""
        cfg_b = dataclasses.replace(
            cfg_b, moe_capacity_factor=cfg_b.n_experts / cfg_b.experts_top_k)
        model_b = init_lm(cfg_b, seed=3, dtype=torch.float32, device=dev)
        toks = torch.randint(0, cfg_b.vocab, (Bb, Sb),
                             generator=gen.manual_seed(4), device=dev)
        err, flips, checked, skipped, ties = 0.0, 0, 0, 0, 0
        with torch.no_grad(), record_routing(model_b) as log:
            last, cache_b = forward_prefill(model_b, cfg_b, toks, Sb + 4,
                                            cache_dtype=torch.float32)
            if not all(bool(r.routing.keep.all()) for r in log):
                fail(f"phase 13b {label}: prefill dropped a token at "
                     f"capacity factor {cfg_b.moe_capacity_factor}")
            seq = toks
            cur = torch.argmax(last, -1)
            for step in range(4):
                dec, cache_b = serve_step(model_b, cfg_b, cur, Sb + step,
                                          cache_b)
                seq = torch.cat([seq, cur[:, None]], dim=1)
                with record_routing(model_b) as train_log:
                    ref = forward_train(model_b, cfg_b, seq)[:, -1]
                diff = compare_routing(
                    routing_by_layer(train_log, cfg_b.n_layers),
                    routing_by_layer(log, cfg_b.n_layers), gap_tol=MOE_TIE)
                if diff.wide:
                    fail(f"phase 13b {label} step {step}: {diff.wide} "
                         f"routing differences at a top-k gap >= {MOE_TIE}")
                ties = diff.near_ties
                ok = diff.first_tainted.to(dev) > Sb + step
                skipped += int(not bool(ok.all()))
                if ok.any():
                    err = max(err, float((dec[ok] - ref[ok]).abs().max()))
                    top2 = torch.topk(ref[ok], 2, dim=-1).values
                    clear = (top2[:, 0] - top2[:, 1]) > 2 * LM_ATOL
                    same = torch.argmax(dec[ok], -1) == torch.argmax(
                        ref[ok], -1)
                    checked += int(clear.sum())
                    flips += int((clear & ~same).sum())
                cur = torch.argmax(dec, -1)
        if err > LM_ATOL or flips or skipped > 1:
            fail(f"phase 13b {label}: max |decode - forward_train| {err:.3g}"
                 f" (atol {LM_ATOL}), {flips} greedy ids differ, {skipped} "
                 f"of 4 steps skipped by the routing rule")
        print(f"phase 13b {label} f32 B={Bb} prompt={Sb}, capacity factor "
              f"{cfg_b.moe_capacity_factor:.4f} = n_experts / top_k "
              f"(capacity = S, no token dropped, so decode's no_drop == "
              f"forward_train): 4 decode steps == forward_train's last row, "
              f"max_abs_err {err:.3g} (atol {LM_ATOL}); greedy ids equal on "
              f"{checked} of {4 * Bb} steps with a top-2 gap > "
              f"{2 * LM_ATOL}; routing equal but {ties} near-tie tokens "
              f"(gap < {MOE_TIE}), {skipped} of 4 steps skipped [{smi}]",
              flush=True)
        del model_b, cache_b
        free_card()

    consistency(f"{cfg.name} full width, 2 of {cfg.n_layers} layers",
                dataclasses.replace(cfg, n_layers=2), 2, 64)
    mix = get_config("mixtral-8x22b")
    consistency(f"mixtral-8x22b full width, 2 of {mix.n_layers} layers, "
                f"window {mix.sliding_window}",
                dataclasses.replace(mix, n_layers=2), 1,
                mix.sliding_window + 4)

    # (c) the card against the CPU, float32 -----------------------------------
    cfg_c = dataclasses.replace(cfg, n_layers=2)
    model_c = init_lm(cfg_c, seed=5, dtype=torch.float32, device=dev)
    head_c = init_li_head(cfg_c, seed=6, dtype=torch.float32, device=dev)
    cpu_model = DecoderLM(cfg_c, torch.float32, "cpu")
    cpu_model.load_state_dict(model_c.state_dict())
    cpu_head = init_li_head(cfg_c, seed=6, dtype=torch.float32, device="cpu")
    cpu_head.load_state_dict(head_c.state_dict())
    g5 = torch.Generator(device="cpu").manual_seed(5)
    toks = torch.randint(0, cfg_c.vocab, (2, 64), generator=g5)
    mask = torch.arange(64)[None, :] < torch.tensor([[64], [40]])
    with torch.no_grad():
        with record_routing(model_c) as log_card:
            got = encode_tokens(model_c, head_c, cfg_c, toks, mask)[0].cpu()
        with record_routing(cpu_model) as log_cpu:
            want = encode_tokens(cpu_model, cpu_head, cfg_c, toks, mask)[0]
    diff = compare_routing(routing_by_layer(log_cpu, 2),
                           routing_by_layer(log_card, 2), gap_tol=MOE_TIE)
    err = max((float((got[b, :f] - want[b, :f]).abs().max()) for b, f in
               enumerate(diff.first_tainted.tolist()) if f > 0), default=0.0)
    if diff.wide or err > ENC_ATOL or got[~mask].any() or want[~mask].any():
        fail(f"phase 13c: card vs CPU max_abs_err {err:.3g} (atol "
             f"{ENC_ATOL}), {diff.wide} wide routing differences, or a "
             f"masked row is not 0")
    print(f"phase 13c encode_tokens {cfg.name} full width, 2 layers, f32: "
          f"card == CPU within atol {ENC_ATOL} (max_abs_err {err:.3g}); "
          f"routing equal but {diff.near_ties} near-tie tokens, rows "
          f"compared up to {diff.first_tainted.tolist()} of 64; masked rows "
          f"0 [{smi}]", flush=True)
    del model_c, head_c, cpu_model
    free_card()

    # (e) recsys at full width ------------------------------------------------
    def call_ms(fn, reps=5):
        """Median ms of one call (CUDA events), after a warm call."""
        fn()
        return statistics.median(event_ms(fn)[0] for _ in range(reps))

    n_check = 4096
    rec = {}
    fm_comps = None
    for arch in ("fm", "autoint", "din", "sasrec"):
        rcfg = get_config(arch)
        shape = {s.name: s for s in rcfg.shapes}
        n_batch = shape["serve_p99"].batch                     # 512
        n_cand = shape["retrieval_cand"].n_candidates          # 10^6
        t = time.perf_counter()
        m = getattr(R, f"init_{arch}")(rcfg, seed=7, device=dev)
        sync()
        n_bytes = sum(p.numel() * p.element_size() for p in m.parameters())
        init_s = time.perf_counter() - t
        cpu_m = type(m)(rcfg, torch.float32, "cpu")
        cpu_m.load_state_dict(m.state_dict())
        g7 = torch.Generator(device="cpu").manual_seed(7)
        if rcfg.vocab_sizes:
            ids = torch.stack([torch.randint(0, v, (n_batch,), generator=g7)
                               for v in rcfg.vocab_sizes], dim=1)
            fwd_args = (ids,)
            ctx = torch.stack([torch.randint(0, v, (), generator=g7)
                               for v in rcfg.vocab_sizes[:-1]])
            cand = torch.randint(0, rcfg.vocab_sizes[-1], (n_cand,),
                                 generator=g7)
            score_args = (ctx, cand)
            pool = rcfg.vocab_sizes[-1]
        else:
            hist = torch.randint(0, rcfg.item_vocab, (n_batch, rcfg.seq_len),
                                 generator=g7)
            hmask = torch.arange(rcfg.seq_len)[None, :] < torch.randint(
                1, rcfg.seq_len + 1, (n_batch, 1), generator=g7)
            target = torch.randint(0, rcfg.item_vocab, (n_batch,),
                                   generator=g7)
            fwd_args = (hist, hmask, target)
            hmask0 = torch.ones((rcfg.seq_len,), dtype=torch.bool)
            cand = torch.randint(0, rcfg.item_vocab, (n_cand,), generator=g7)
            score_args = (hist[0], hmask0, cand)
            pool = rcfg.item_vocab
        fwd = getattr(R, f"{arch}_forward")
        score = getattr(R, f"{arch}_score_candidates")
        d_fwd = tuple(a.to(dev) for a in fwd_args)
        d_score = tuple(a.to(dev) for a in score_args)
        with torch.no_grad():
            p99_ms = call_ms(lambda: fwd(m, rcfg, *d_fwd))
            cand_ms = call_ms(lambda: score(m, rcfg, *d_score), reps=3)
            got_f = fwd(m, rcfg, *d_fwd).cpu()
            got_s = score(m, rcfg, *d_score)
            want_f = fwd(cpu_m, rcfg, *fwd_args)
            want_s = score(cpu_m, rcfg, *score_args[:-1],
                           score_args[-1][:n_check])
        if got_s.shape != (n_cand,) or not torch.isfinite(got_s).all():
            fail(f"phase 13e {arch}: malformed candidate scores")
        err = max(float((got_f - want_f).abs().max()),
                  float((got_s[:n_check].cpu() - want_s).abs().max()))
        if err > REC_ATOL:
            fail(f"phase 13e {arch}: card vs CPU max_abs_err {err:.3g} "
                 f"(atol {REC_ATOL})")
        extra = ""
        if arch == "fm":
            with torch.no_grad():
                comps = R.fm_candidate_components(m, rcfg, *d_score)
            c_err = float((comps.sum(-1) - got_s).abs().max())
            if comps.shape != (n_cand, rcfg.n_sparse) or c_err > REC_ATOL:
                fail(f"phase 13e fm: components {tuple(comps.shape)} sum to "
                     f"the scores within {c_err:.3g} (atol {REC_ATOL})")
            fm_comps = comps[:n_check].contiguous()
            extra = (f"; fm_candidate_components {tuple(comps.shape)} sum "
                     f"to fm_score_candidates within {c_err:.3g}")
            del comps
        rec[arch] = dict(serve_p99_ms=round(p99_ms, 4),
                         retrieval_cand_ms=round(cand_ms, 3),
                         param_gb=round(n_bytes / 1e9, 3))
        print(f"phase 13e {arch} full width: {n_bytes / 1e9:.3f} GB f32 on "
              f"{dev} (drawn in {init_s:.1f} s); serve_p99 forward "
              f"B={n_batch} {p99_ms:.4f} ms; retrieval_cand 1 x {n_cand} candidates "
              f"(uniform over {pool} ids) {cand_ms:.3f} ms per call; card "
              f"== CPU on the forward and the first {n_check} candidates "
              f"within atol {REC_ATOL} (max_abs_err {err:.3g}){extra} "
              f"[{smi}]", flush=True)
        del m, cpu_m, got_s
        free_card()
    print(f"phase 13e json {json.dumps(rec)}", flush=True)

    # (f) the generalized Col-Bandit ------------------------------------------
    grid, same_cpu = [], 0
    for alpha in (0.1, 0.3, 1.0):
        covs, ovs = [], []
        for seed in range(4):
            rng = np.random.default_rng(seed)
            ctx = torch.from_numpy((rng.standard_normal((16, 10)) * 0.3
                                    ).astype(np.float32))
            cands = torch.from_numpy((rng.standard_normal((4096, 10)) * 0.3
                                      ).astype(np.float32))
            comps = fm_pair_components(ctx.to(dev), cands.to(dev))
            exact, _ = exact_topk(comps, k=10)
            kw = dict(k=10, alpha_ef=alpha, block_docs=64, block_tokens=2)
            r = topk_bandit_generalized(comps, seed, **kw)
            covs.append(float(r.coverage))
            ovs.append(float(overlap_at_k(r.topk.cpu(), exact.cpu())))
            if seed == 0:
                r_cpu = topk_bandit_generalized(comps.cpu(), seed, **kw)
                same = torch.equal(r.topk.cpu(), r_cpu.topk)
                same_cpu += int(same)
                print(f"phase 13f alpha_ef={alpha} seed 0: card ids == "
                      f"CPU ids {same} (coverage {float(r.coverage):.4f} / "
                      f"{float(r_cpu.coverage):.4f}, rounds "
                      f"{int(r.rounds)} / {int(r_cpu.rounds)})", flush=True)
        grid.append(dict(alpha_ef=alpha, coverage=round(float(np.mean(covs)),
                                                        4),
                         overlap=round(float(np.mean(ovs)), 4)))
    print(f"phase 13f generalized bandit, 4096 candidates x 16 fields, k=10, "
          f"seeds 0-3: {json.dumps(grid)}; card ids == CPU ids at seed 0 "
          f"for {same_cpu} of 3 alpha_ef (reported, no gate) [{smi}]",
          flush=True)
    exact, _ = exact_topk(fm_comps, k=10)
    r = topk_bandit_generalized(fm_comps, 0, k=10, alpha_ef=0.3,
                                block_docs=64, block_tokens=2)
    print(f"phase 13f generalized bandit on full-width FM components "
          f"{tuple(fm_comps.shape)}: coverage {float(r.coverage):.4f}, "
          f"overlap@10 with exact_topk "
          f"{float(overlap_at_k(r.topk.cpu(), exact.cpu())):.4f}, rounds "
          f"{int(r.rounds)} [{smi}]", flush=True)
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s; elapsed "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    return {kname: sum(run[kname] for run in launches.values())
            for kname in launches["dense"]}


def _train_state_leaves(state):
    from repro_torch.ckpt.checkpoint import state_leaves
    return {k: t.detach().clone() for k, t in state_leaves(state)}


def train_resume_check(dev) -> dict:
    """14(c), run in a child process (``--train-resume``): a ``Trainer``
    on the JAX restart test's tiny config crashes at step 7 through
    ``simulate_failure``, restores the step-5 checkpoint and must end on the
    parameters and moments of an uninterrupted 12-step run bit for bit."""
    import tempfile

    from repro_torch.configs.base import LMConfig
    from repro_torch.dist.fault import simulate_failure
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.optimizer import adamw, cosine_schedule
    from repro_torch.train.train_step import (init_train_state,
                                              make_lm_train_step)
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = LMConfig(name="tiny", n_layers=2, d_model=32, n_heads=2,
                   n_kv_heads=2, d_head=16, d_ff=64, vocab=128)

    def batch_fn(step):
        rng = np.random.default_rng([123, step])
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16))).to(dev)
        return {"tokens": toks, "targets": torch.roll(toks, -1, dims=1)}

    def build(ckpt_dir):
        opt = adamw(cosine_schedule(1e-3, 2, 12))
        state = init_train_state(init_lm(cfg, seed=0, device=dev), opt)
        return Trainer(make_lm_train_step(cfg, opt), batch_fn, state,
                       TrainerConfig(total_steps=12, ckpt_every=5,
                                     ckpt_dir=ckpt_dir, log_every=100,
                                     async_ckpt=True))

    t = time.perf_counter()
    ref = _train_state_leaves(build(None).run())
    with tempfile.TemporaryDirectory() as d:
        tr = build(d)
        fired = simulate_failure(lambda guard: tr.run(guard), fail_at_step=7)
        tr.ckpt.wait()
        tr2 = build(d)
        tr2.maybe_restore()
        out = _train_state_leaves(tr2.run())
        start = tr2.start_step
    differ = [k for k in ref if not torch.equal(ref[k], out[k])]
    return dict(fired=fired, resumed_from=start, leaves=len(ref),
                differ=differ, step=int(out["opt.step"]),
                seconds=round(time.perf_counter() - t, 2),
                deterministic=torch.are_deterministic_algorithms_enabled())


def training(dev, profiled_line, smi, t_start):
    """14. Training on the card (``repro_torch.train``, ``ckpt``,
    ``models/gnn.py``): plain PyTorch and autograd, no ported kernel (the
    JAX package's train steps reach no Pallas kernel). TF32 stays off, so
    float32 products run in full float32.

    (a) Qwen2.5-3B at full width and depth (36 layers, 3.397 B parameters)
        in bf16, float32 AdamW moments: ``train_4k``'s 4,096 tokens at B =
        2 (cut from its global batch of 256), ``remat=True``, the CE in
        chunks of ``chunk_tokens`` (8,192 unless the reckoned peak does not
        fit what is free), ``adamw(cosine_schedule)``, 4 steps on one
        seeded batch: step ms (CUDA events, median of steps 2-4), tokens/s,
        the bound by operations, peak memory, each step's loss and
        grad_norm (the loss must be finite and fall), and a fifth step
        profiled (device busy time, idle share, top kernels).
    (b) Qwen2.5-3B at full width cut to 2 layers, float32: one train step
        on the card against the same step on the CPU (loss, grad_norm,
        updated parameters and moments), and ``num_microbatches=2`` against
        1 on the gradients.
    (c) Crash-safe resume (``train_resume_check``) in a child process with
        ``torch.use_deterministic_algorithms(True)`` and
        ``CUBLAS_WORKSPACE_CONFIG=:4096:8``: the embedding lookup's
        backward (``index_put_`` with accumulate) and the CE's ``gather``
        backward (``scatter_add_``) add with atomics in the default mode,
        so two runs may differ in the last bit.
    (d) Moonlight-16B-A3B at full width cut to 2 of 48 layers (its full
        training state, 28 B x 16 bytes, fits no card), float32: a train
        step at its capacity factor (tokens dropped) timed on the card;
        the first step's loss and grad_norm held to the CPU's under the
        routing rule of phase 13 (targets from a near-tie flip on masked).
    (e) PNA at its full width (4 layers, d_hidden 75): train steps on
        ``full_graph_sm`` (a random 2,708-node, 10,556-edge graph, d_feat
        1,433), ``molecule`` (128 graphs of 30 nodes and 64 edges) and one
        ``minibatch_lg`` batch (1,024 seeds, fanout 15 / 10, sampled from
        a random 232,965-node graph, d_feat 602); card against CPU on loss
        and gradients, and ``pna_loss_sharded`` at S = 4 on the one card
        against ``pna_loss``.
    (f) Recsys at each config's full width, float32: ``train_batch`` (B =
        65,536) steps of FM, AutoInt, DIN and SASRec: step ms, the first
        step held to the CPU's (loss, grad_norm, the updated rows the batch
        touched and the dense weights), the loss falling over 3 steps.
    (g) Compressed data parallelism: S = 4 shards on the one card, the
        tiny config of (c), 25 steps of ``int8_rs_ag`` with error feedback
        (the loss must fall by >= 0.3, JAX's bar), step ms with and without
        compression, and the int8 bytes a shard sends a step.

    Prints one ``phase 14 json`` line with every number."""
    from repro_torch.configs import get_config
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.models import gnn as G
    from repro_torch.models import recsys as R
    from repro_torch.models.moe import (compare_routing, record_routing,
                                        routing_by_layer)
    from repro_torch.models.transformer import (DecoderLM, forward_hidden,
                                                init_lm)
    from repro_torch.train.compressed_step import (
        init_compressed_state, jax_leaf_groups,
        make_compressed_lm_train_step)
    from repro_torch.train.compression import int8_rs_ag_wire_bytes
    from repro_torch.train.optimizer import adamw, cosine_schedule, \
        global_norm
    from repro_torch.train.train_step import (init_train_state, lm_grads,
                                              lm_loss, make_gnn_train_step,
                                              make_lm_train_step,
                                              make_recsys_train_step,
                                              named_params, value_and_grad)

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    summary = {}
    child = None
    if on_card:
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        held = torch.cuda.memory_allocated()
        print(f"phase 14: torch.cuda.mem_get_info() free {free / 1e9:.2f} "
              f"GB of {total / 1e9:.2f} GB; {held / 1e9:.2f} GB allocated by "
              f"earlier phases [{smi}]", flush=True)
        # (c) runs beside (a)-(b) in its own process
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        child = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                  "--train-resume"], env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
    else:
        free, held = 0, 0
    bf16_peak = 989e12        # dense bf16 tensor-core peak, H100 SXM
    cpu = torch.device("cpu")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def event_ms(fn):
        if not on_card:
            t = time.perf_counter()
            out = fn()
            return (time.perf_counter() - t) * 1e3, out
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), out

    def to_cpu(model, cls_args):
        twin = type(model)(*cls_args, device="cpu")
        twin.load_state_dict(model.state_dict())
        return twin

    def rel_err(got, want):
        """max |got - want| / max |want| over leaves of two name dicts."""
        num = max(float((got[k].detach().cpu().float() - want[k].float())
                        .abs().max()) for k in want)
        den = max(float(want[k].float().abs().max()) for k in want)
        return num / max(den, 1e-30)

    try:
        # (a) Qwen2.5-3B, full width and depth, bf16 --------------------------
        cfg = get_config("qwen2.5-3b")
        shape = {s.name: s for s in cfg.shapes}["train_4k"]
        B, S = 2, shape.seq_len
        V = cfg.vocab
        t = time.perf_counter()
        model = init_lm(cfg, seed=SEED, dtype=torch.bfloat16, device=dev)
        n_params = sum(p.numel() for p in model.parameters())
        opt = adamw(cosine_schedule(3e-4, 1, 4))
        state = init_train_state(model, opt)
        sync()
        init_s = time.perf_counter() - t
        # reckon the peak: parameters, grads and moments, and the CE chunk
        # (its bf16 and f32 logits, logsumexp's exp and the f32 gradient
        # while the backward recomputes it: 16 bytes a logit; on an H100
        # the peak was 18.6 GB above the state at 8,192 tokens, 14.9 a
        # logit)
        state_bytes = n_params * (2 + 2 + 4 + 4)
        chunk_tokens = 8192
        if on_card:
            room = free - state_bytes - 3e9
            while chunk_tokens > B and 16 * chunk_tokens * V > room:
                chunk_tokens //= 2
        ce_gb = 16 * min(chunk_tokens, B * S) * V / 1e9
        gen = torch.Generator(device=dev).manual_seed(SEED)
        seq = torch.randint(0, V, (B, S + 1), generator=gen, device=dev)
        batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
        step = make_lm_train_step(cfg, opt, chunk_tokens=chunk_tokens)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if on_card else 0
        losses, gnorms, times = [], [], []
        for i in range(4):
            ms, (state, m) = event_ms(lambda: step(state, batch))
            times.append(ms)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        peak = (torch.cuda.max_memory_allocated() - held) if on_card else 0
        if not all(np.isfinite(losses + gnorms)):
            fail(f"phase 14a: non-finite loss or grad_norm {losses} {gnorms}")
        if not losses[-1] < losses[0]:
            fail(f"phase 14a: the loss did not fall: {losses}")
        step_ms = statistics.median(times[1:])
        # a fifth step, profiled: device busy time, idle share, top kernels
        print(profiled_line("phase 14a train step",
                            lambda: step(state, batch), step_ms),
              flush=True)
        embed = cfg.vocab * cfg.d_model
        flops = (6 * (n_params - embed) * B * S
                 + 6 * B * S * S * cfg.n_heads * cfg.d_head * cfg.n_layers)
        bound_ms = flops / bf16_peak * 1e3
        summary["14a"] = dict(
            model=cfg.name, params=n_params, B=B, S=S,
            chunk_tokens=chunk_tokens, step_ms=round(step_ms, 2),
            step_ms_each=[round(x, 2) for x in times],
            tokens_per_s=round(B * S / step_ms * 1e3, 1),
            bound_ms=round(bound_ms, 2), flops=flops,
            peak_gb_above_earlier=round(peak / 1e9, 2),
            reckoned_gb=round(state_bytes / 1e9 + ce_gb, 2),
            losses=[round(x, 5) for x in losses],
            grad_norms=[round(x, 4) for x in gnorms])
        print(f"phase 14a {cfg.name}: {n_params} parameters, bf16, drawn in "
              f"{init_s:.1f} s; B={B} x S={S} (train_4k cut from global "
              f"batch {shape.global_batch}), remat, chunk_tokens "
              f"{chunk_tokens}: step {step_ms:.1f} ms (median of steps 2-4; "
              f"each {[round(x, 1) for x in times]}), "
              f"{B * S / step_ms * 1e3:.0f} tokens/s, bound {bound_ms:.1f} ms "
              f"by operations ({flops:.3e} FLOP at 989 TFLOP/s bf16); peak "
              f"{peak / 1e9:.2f} GB above the {held / 1e9:.2f} GB earlier "
              f"phases hold (reckoned {state_bytes / 1e9:.1f} GB of state + "
              f"{ce_gb:.1f} GB CE chunk); losses {losses}; grad_norm "
              f"{gnorms} [{smi}]", flush=True)
        del state, model, step, batch, seq
        if on_card:
            torch.cuda.empty_cache()

        print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
        # (b) consistency: 2 layers, f32, card vs CPU --------------------------
        cfg2 = dataclasses.replace(cfg, n_layers=2)
        model = init_lm(cfg2, seed=SEED + 1, device=dev)
        cpu_model = to_cpu(model, (cfg2, torch.float32))
        g2 = torch.Generator(device="cpu").manual_seed(1)
        seq = torch.randint(0, V, (4, 33), generator=g2)
        tk, tg = seq[:, :-1], seq[:, 1:]
        b2 = {"tokens": tk[:2], "targets": tg[:2]}
        opt = adamw(1e-4, eps=1e-4)
        st_d = init_train_state(model, opt)
        st_c = init_train_state(cpu_model, opt)
        st_d, m_d = make_lm_train_step(cfg2, opt)(
            st_d, {k: v.to(dev) for k, v in b2.items()})
        st_c, m_c = make_lm_train_step(cfg2, opt)(st_c, b2)
        errs = dict(
            loss=abs(float(m_d["loss"]) - float(m_c["loss"])),
            grad_norm_rel=abs(float(m_d["grad_norm"]) / float(m_c["grad_norm"])
                              - 1),
            params=max(float((p.detach().cpu() - q.detach()).abs().max())
                       for (_, p), (_, q) in zip(
                           model.named_parameters(),
                           cpu_model.named_parameters())),
            m_rel=rel_err(st_d.opt.m, st_c.opt.m))
        lims = dict(loss=1e-4, grad_norm_rel=1e-4, params=1e-6, m_rel=1e-4)
        bad = {k: v for k, v in errs.items() if not v <= lims[k]}
        if bad:
            fail(f"phase 14b: card vs CPU {bad} beyond {lims}")
        l1, g1 = lm_grads(model, cfg2, tk.to(dev), tg.to(dev))
        l2, gm = lm_grads(model, cfg2, tk.to(dev), tg.to(dev),
                          num_microbatches=2)
        mb_err = rel_err(gm, {k: v.float().cpu() for k, v in g1.items()})
        if not (mb_err <= 1e-5 and abs(float(l1) - float(l2)) <= 1e-5):
            fail(f"phase 14b: num_microbatches=2 vs 1: grads rel err "
                 f"{mb_err:.3g}, loss {float(l1)} vs {float(l2)}")
        summary["14b"] = dict(errs={k: float(f"{v:.3g}") for k, v in
                                    errs.items()}, limits=lims,
                              microbatch_grad_rel_err=float(f"{mb_err:.3g}"))
        print(f"phase 14b {cfg.name} full width, 2 layers, f32, B=2 x 32: "
              f"card vs CPU after one step: |loss| {errs['loss']:.3g}, "
              f"grad_norm rel {errs['grad_norm_rel']:.3g}, params max abs "
              f"{errs['params']:.3g} (lr 1e-4, eps 1e-4), m rel "
              f"{errs['m_rel']:.3g} (limits {lims}); num_microbatches=2 vs "
              f"1 (B=4): grads rel err {mb_err:.3g}", flush=True)
        del model, cpu_model, st_d, st_c, g1, gm
        if on_card:
            torch.cuda.empty_cache()

        print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
        # (d) Moonlight-16B-A3B, full width, 2 layers, f32 --------------------
        mcfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"),
                                   n_layers=2)
        model = init_lm(mcfg, seed=SEED + 2, device=dev)
        m_params = sum(p.numel() for p in model.parameters())
        cpu_model = to_cpu(model, (mcfg, torch.float32))
        g3 = torch.Generator(device="cpu").manual_seed(2)
        seq = torch.randint(0, mcfg.vocab, (2, 65), generator=g3)
        tk, tg = seq[:, :-1], seq[:, 1:].clone()
        with torch.no_grad():
            with record_routing(model) as log_d:
                forward_hidden(model, mcfg, tk.to(dev))
            with record_routing(cpu_model) as log_c:
                forward_hidden(cpu_model, mcfg, tk)
        diff = compare_routing(routing_by_layer(log_c, mcfg.n_layers),
                               routing_by_layer(log_d, mcfg.n_layers),
                               gap_tol=MOE_TIE)
        if diff.wide:
            fail(f"phase 14d: {diff.wide} routing flips at a gap >= {MOE_TIE}")
        for b_i, f_i in enumerate(diff.first_tainted.tolist()):
            tg[b_i, f_i:] = -1           # left out from the first flip on
        dropped = sum(int((~r.routing.keep).sum()) for r in log_d)
        opt = adamw(1e-4, eps=1e-4)
        st_d = init_train_state(model, opt)
        step = make_lm_train_step(mcfg, opt)
        bm = {"tokens": tk.to(dev), "targets": tg.to(dev)}
        ms1, (st_d, m_d) = event_ms(lambda: step(st_d, bm))
        loss_d, gn_d = float(m_d["loss"]), float(m_d["grad_norm"])
        l_c, g_c = value_and_grad(
            lambda: lm_loss(cpu_model, mcfg, tk, tg), cpu_model)
        gn_c = float(global_norm(g_c))
        del g_c
        ms2, (st_d, m_d2) = event_ms(lambda: step(st_d, bm))
        err_l, err_g = abs(loss_d - float(l_c)), abs(gn_d / gn_c - 1)
        if not (np.isfinite(loss_d) and err_l <= 1e-4 and err_g <= 1e-4):
            fail(f"phase 14d: card loss {loss_d} grad_norm {gn_d} vs CPU "
                 f"{float(l_c)} / {gn_c}")
        summary["14d"] = dict(model=mcfg.name, layers=2, params=m_params,
                              step_ms=round(ms2, 2), first_step_ms=round(ms1, 2),
                              loss=round(loss_d, 5),
                              loss_step2=round(float(m_d2["loss"]), 5),
                              loss_err=float(f"{err_l:.3g}"),
                              grad_norm_rel_err=float(f"{err_g:.3g}"),
                              near_tie_flips=diff.near_ties,
                              slots_dropped=dropped)
        print(f"phase 14d {mcfg.name} full width, 2 of 48 layers, "
              f"{m_params} parameters, f32, B=2 x 64, capacity factor "
              f"{mcfg.moe_capacity_factor} ({dropped} slots dropped): step "
              f"{ms2:.1f} ms (first {ms1:.1f}); loss {loss_d:.5f} -> "
              f"{float(m_d2['loss']):.5f}; card vs CPU |loss| {err_l:.3g}, "
              f"grad_norm rel {err_g:.3g}; {diff.near_ties} near-tie routing "
              f"flips, 0 wide", flush=True)
        del model, cpu_model, st_d, step
        if on_card:
            torch.cuda.empty_cache()
        print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
        # (e) PNA at full width ----------------------------------------------
        gcfg = get_config("pna")
        gshape = {s.name: s for s in gcfg.shapes}
        graphs = {}
        sm = gshape["full_graph_sm"]
        graphs["full_graph_sm"] = G.random_graph(
            sm.n_nodes, sm.n_edges, sm.d_feat, gcfg.n_classes, seed=SEED)
        mol = gshape["molecule"]
        graphs["molecule"] = G.batch_molecules(
            mol.graph_batch, mol.n_nodes, mol.n_edges, mol.d_feat,
            gcfg.n_classes, seed=SEED)
        lg = gshape["minibatch_lg"]
        # cut: 1/8 of the edges (mean in-degree 61.5, still above the
        # fanout); the full 114.6 M-edge CSR took 49.0 s on the host
        lg_edges = lg.n_edges // 8
        t = time.perf_counter()
        big = G.random_graph(lg.n_nodes, lg_edges, lg.d_feat,
                             gcfg.n_classes, seed=SEED)
        t_rand = time.perf_counter() - t
        t = time.perf_counter()
        csr = G.build_csr(lg.n_nodes, big.senders.numpy(),
                          big.receivers.numpy())
        t_csr = time.perf_counter() - t
        t = time.perf_counter()
        seeds = np.random.default_rng(SEED).choice(lg.n_nodes,
                                                   lg.batch_nodes,
                                                   replace=False)
        graphs["minibatch_lg"] = G.sample_subgraph(
            csr, big.feats.numpy(), big.labels.numpy(), seeds, lg.fanout,
            seed=SEED)
        t_sample = time.perf_counter() - t
        del big, csr
        print(f"phase 14e minibatch_lg graph: {lg.n_nodes} nodes, "
              f"{lg_edges} edges (1/8 of the shape's {lg.n_edges}): drawn "
              f"{t_rand:.1f} s, CSR {t_csr:.1f} s, "
              f"{lg.batch_nodes} seeds sampled at fanout {lg.fanout} in "
              f"{t_sample:.2f} s -> {graphs['minibatch_lg'].feats.shape[0]} "
              f"nodes, {graphs['minibatch_lg'].senders.shape[0]} edges",
              flush=True)
        summary["14e"] = dict(csr_s=round(t_csr, 2), draw_s=round(t_rand, 2),
                              minibatch_lg_edges=lg_edges)
        for gname, g in graphs.items():
            d_feat = g.feats.shape[1]
            model = G.init_pna(gcfg, d_feat, seed=SEED, device=dev)
            cpu_model = to_cpu(model, (gcfg, d_feat, torch.float32))
            gd = g.to(dev)
            l_c, g_c = value_and_grad(
                lambda: G.pna_loss(cpu_model, gcfg, g), cpu_model)
            opt = adamw(1e-3)
            st = init_train_state(model, opt)
            l_d, g_d = value_and_grad(lambda: G.pna_loss(model, gcfg, gd),
                                      model)
            gerr = max(float(torch.linalg.vector_norm(g_d[k].cpu() - g_c[k])
                             / torch.linalg.vector_norm(g_c[k])) for k in g_c)
            lerr = abs(float(l_d) / float(l_c) - 1)
            if not (lerr <= PNA_LOSS_REL and gerr <= PNA_GRAD_REL):
                fail(f"phase 14e {gname}: card vs CPU loss rel {lerr:.3g}, "
                     f"grad rel {gerr:.3g} (limits {PNA_LOSS_REL}, "
                     f"{PNA_GRAD_REL})")
            step = make_gnn_train_step(gcfg, opt)
            losses, times = [], []
            for _ in range(3):
                ms, (st, mm) = event_ms(lambda: step(st, gd))
                times.append(ms)
                losses.append(float(mm["loss"]))
            if not all(np.isfinite(losses)):
                fail(f"phase 14e {gname}: losses {losses}")
            rec = dict(nodes=g.feats.shape[0], edges=g.senders.shape[0],
                       d_feat=d_feat, step_ms=round(statistics.median(
                           times[1:]), 3),
                       losses=[round(x, 5) for x in losses],
                       loss_rel_err=float(f"{lerr:.3g}"),
                       grad_rel_err=float(f"{gerr:.3g}"))
            if gname == "full_graph_sm":
                n_sh = 4
                s_, r_, m_ = G.partition_edges_by_dst(
                    g.senders.numpy(), g.receivers.numpy(),
                    g.feats.shape[0], n_sh)
                gs = g._replace(senders=torch.from_numpy(s_),
                                receivers=torch.from_numpy(r_),
                                edge_mask=torch.from_numpy(m_)).to(dev)
                fresh = G.init_pna(gcfg, d_feat, seed=SEED + 1, device=dev)
                mesh = make_mesh((n_sh,), ("data",), device=dev)
                l_s, g_s = value_and_grad(
                    lambda: G.pna_loss_sharded(fresh, gcfg, gs, mesh), fresh)
                l_1, g_1 = value_and_grad(
                    lambda: G.pna_loss(fresh, gcfg, gd), fresh)
                serr = max(float(torch.linalg.vector_norm(g_s[k] - g_1[k])
                                 / torch.linalg.vector_norm(g_1[k]))
                           for k in g_1)
                slerr = abs(float(l_s) / float(l_1) - 1)
                if not (slerr <= PNA_LOSS_REL and serr <= PNA_GRAD_REL):
                    fail(f"phase 14e: pna_loss_sharded S={n_sh} vs pna_loss:"
                         f" loss rel {slerr:.3g}, grad rel {serr:.3g}")
                rec.update(sharded_loss_rel_err=float(f"{slerr:.3g}"),
                           sharded_grad_rel_err=float(f"{serr:.3g}"))
                del fresh
            summary["14e"][gname] = rec
            print(f"phase 14e pna {gname}: {rec}", flush=True)
            del model, cpu_model, st, step, gd
        del graphs
        if on_card:
            torch.cuda.empty_cache()

        print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
        # (f) recsys train_batch at full width -------------------------------
        summary["14f"] = {}
        for arch in ("fm", "autoint", "din", "sasrec"):
            rcfg = get_config(arch)
            nb = {s.name: s for s in rcfg.shapes}["train_batch"].batch
            model = getattr(R, f"init_{arch}")(rcfg, seed=SEED, device=dev)
            cpu_model = to_cpu(model, (rcfg, torch.float32))
            gr = torch.Generator(device="cpu").manual_seed(3)
            if rcfg.vocab_sizes:
                batch = {"ids": torch.stack(
                    [torch.randint(0, v, (nb,), generator=gr)
                     for v in rcfg.vocab_sizes], dim=1)}
                table, offs = "table", R.field_offsets(rcfg.vocab_sizes)
                rows = (batch["ids"][:4] + torch.as_tensor(offs)).reshape(-1)
            else:
                batch = {"hist_ids": torch.randint(
                    0, rcfg.item_vocab, (nb, rcfg.seq_len), generator=gr),
                    "target_ids": torch.randint(0, rcfg.item_vocab, (nb,),
                                                generator=gr)}
                batch["hist_mask"] = torch.arange(rcfg.seq_len)[None, :] < \
                    torch.randint(1, rcfg.seq_len + 1, (nb, 1), generator=gr)
                table = "item_table"
                rows = batch["target_ids"][:16]
            batch["labels"] = torch.randint(0, 2, (nb,), generator=gr).float()
            opt = adamw(1e-3, eps=1e-4)
            st_d, st_c = init_train_state(model, opt), \
                init_train_state(cpu_model, opt)
            step = make_recsys_train_step(rcfg, opt)
            bd = {k: v.to(dev) for k, v in batch.items()}
            losses, times = [], []
            for i in range(3):
                ms, (st_d, mm) = event_ms(lambda: step(st_d, bd))
                times.append(ms)
                losses.append(float(mm["loss"]))
                if i == 0:
                    after = {k: p.detach().clone() for k, p in
                             model.named_parameters() if k != table}
                    after[table] = getattr(model, table).detach()[
                        rows.to(dev)].clone()
                    gn_d = float(mm["grad_norm"])
            st_c, mc = step(st_c, batch)
            want = {k: p.detach() for k, p in cpu_model.named_parameters()
                    if k != table}
            want[table] = getattr(cpu_model, table).detach()[rows]
            p_err = max(float((after[k].cpu() - want[k]).abs().max())
                        for k in want)
            l_err = abs(losses[0] - float(mc["loss"]))
            g_err = abs(gn_d / float(mc["grad_norm"]) - 1)
            if not (l_err <= 1e-5 and g_err <= 1e-4 and p_err <= 1e-5):
                fail(f"phase 14f {arch}: card vs CPU |loss| {l_err:.3g}, "
                     f"grad_norm rel {g_err:.3g}, params {p_err:.3g}")
            if not (all(np.isfinite(losses)) and losses[2] < losses[0]):
                fail(f"phase 14f {arch}: losses {losses}")
            n_p = sum(p.numel() for p in model.parameters())
            rec = dict(params=n_p, batch=nb,
                       step_ms=round(statistics.median(times[1:]), 3),
                       step_ms_each=[round(x, 3) for x in times],
                       losses=[round(x, 6) for x in losses],
                       loss_err=float(f"{l_err:.3g}"),
                       grad_norm_rel_err=float(f"{g_err:.3g}"),
                       rows_checked=int(rows.numel()),
                       param_err=float(f"{p_err:.3g}"))
            summary["14f"][arch] = rec
            print(f"phase 14f {arch} full width f32, train_batch B={nb}: "
                  f"{rec}", flush=True)
            del model, cpu_model, st_d, st_c, after, bd
            if on_card:
                torch.cuda.empty_cache()

        print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
        # (g) compressed data parallel, S = 4 on the one card -----------------
        tcfg = dataclasses.replace(cfg, name="tiny", n_layers=2, d_model=32,
                                   n_heads=2, n_kv_heads=2, d_head=16,
                                   d_ff=64, vocab=128, qkv_bias=False)
        mesh = make_mesh((4,), ("data",), device=dev)
        rng = np.random.default_rng(1)
        toks = torch.from_numpy(rng.integers(0, 128, (8, 16))).to(dev)
        bg = {"tokens": toks, "targets": torch.roll(toks, -1, dims=1)}
        out = {}
        for compress, n_steps in ((True, 25), (False, 6)):
            opt = adamw(1e-3)
            st = init_compressed_state(init_lm(tcfg, seed=0, device=dev),
                                       opt)
            step = make_compressed_lm_train_step(tcfg, opt, mesh,
                                                 compress=compress)
            losses, times = [], []
            for _ in range(n_steps):
                ms, (st, mm) = event_ms(lambda: step(st, bg))
                times.append(ms)
                losses.append(float(mm["loss"]))
            out[compress] = (losses, statistics.median(times[1:]))
            if compress:
                params = named_params(st.params)
                groups = jax_leaf_groups(tcfg, list(params))
                wire = int8_rs_ag_wire_bytes(
                    [sum(params[n].numel() for n in ns)
                     for ns in groups.values()], mesh.size)
                n_el = sum(p.numel() for p in params.values())
        losses = out[True][0]
        ring = 2 * (mesh.size - 1) * n_el * 4 // mesh.size
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.3):
            fail(f"phase 14g: compressed losses {losses}")
        summary["14g"] = dict(shards=4, steps=25, loss_first=round(
            losses[0], 5), loss_last=round(losses[-1], 5),
            step_ms_compressed=round(out[True][1], 3),
            step_ms_uncompressed=round(out[False][1], 3),
            int8_wire_bytes_per_shard_step=wire,
            f32_ring_allreduce_bytes_per_shard_step=ring)
        print(f"phase 14g compressed DP, 4 shards on {dev}, tiny LM ({n_el} "
              f"parameters): loss {losses[0]:.4f} -> {losses[-1]:.4f} in 25 "
              f"int8_rs_ag steps; step {out[True][1]:.2f} ms compressed, "
              f"{out[False][1]:.2f} ms pmean; a shard sends {wire} int8 "
              f"bytes a step (a ring f32 all-reduce: {ring})", flush=True)

        print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
        # (c) the child's resume check ----------------------------------------
        if child is not None:
            outs, errs = child.communicate(timeout=300)
            child = None
            line = [x for x in outs.splitlines()
                    if x.startswith("train-resume ")]
            if not line:
                fail(f"phase 14c: the child printed no result: {errs[-2000:]}")
            res = json.loads(line[-1][len("train-resume "):])
            if not (res["fired"] and res["resumed_from"] == 5
                    and not res["differ"] and res["step"] == 12
                    and res["deterministic"]):
                fail(f"phase 14c: {res}")
            summary["14c"] = res
            print(f"phase 14c resume on the card (child process, "
                  f"deterministic algorithms, CUBLAS_WORKSPACE_CONFIG="
                  f":4096:8): crashed at step 7, resumed from step 5, "
                  f"{res['leaves']} leaves bit-equal to the uninterrupted "
                  f"12-step run ({res['seconds']} s in the child)", flush=True)
    finally:
        if child is not None:
            child.kill()
            child.wait()
    print(f"phase 14 json {json.dumps(summary)}", flush=True)
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s; elapsed "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)


def long_context(dev, index, ds, cand, profiled_line, smi, t_start,
                 cache_slots=0):
    """15. Long-context decode over a sequence-sharded KV cache, the ring
    collectives and the thread-access recorder (``repro_torch.dist``,
    ``repro_torch.analysis``): split-K decode is plain PyTorch (``jnp`` in
    the JAX package), so only (c) launches kernels.

    (a) Qwen2.5-3B at full width and depth at ``long_500k`` (B = 1, a
        524,288-slot cache; ``cache_slots`` overrides it for a rehearsal),
        bf16 weights and a bf16 cache: K/V of positions 0 .. S - 33 drawn
        seeded (a 524k-token prefill does not fit: one 2,048-query chunk's
        float32 logits over 524k keys are 68.7 GB), then 32 decode steps
        with split-K off (greedy from a seeded token) and the same 32 with
        it on, teacher-forced on the first run's tokens, over a (1, 4)
        ("data", "model") mesh on the card, so 4 sequence shards of 131,072
        slots are views of the one cache: ms a step (CUDA events, median of
        steps 2-32) for both, the byte bound, peak memory above what earlier
        phases hold, one profiled step of each (device busy, idle share),
        and bf16's max |split-K - plain| logits (reported). Then the gate,
        in float32 at full depth over a float32 cache of the same slots: 4
        steps each way, logits within LM_ATOL and greedy ids equal wherever
        the plain run's top-2 gap exceeds 2 * LM_ATOL (phase 12's rule).
    (a') gemma2-27b at full width cut to 2 layers (one local / global pair:
        window 4,096 and softcaps), float32, B = 2 on a (2, 4) mesh (batch
        blocks over "data"): a 4,100-token prefill so the ring wraps, then 4
        steps each way under the same rule.
    (b) The ring collectives on 4 shards of the card: ``ring_all_gather``
        of a (4 x 2,048, 2,048) bf16 tensor equals ``torch.cat`` bit for
        bit on every shard; ``ring_matmul`` of (8,192, 2,048) x (2,048,
        11,008) bf16 equals ``x @ w`` within one bf16 ulp (RING_RTOL) plus
        RING_ATOL, since cuBLAS may pick another algorithm for a row block
        (reduced-precision bf16 reductions off for both); the bytes noted
        per hop.
    (c) The port's ``ThreadAccessRecorder`` wraps an
        ``AsyncRetrievalEngine`` in continuous mode serving 48 requests on
        phase 4's f32 corpus (phase 9's stream): ``violations() == []``,
        and the completions equal an unrecorded engine's bit for bit.
    (d) Split-K over a cache placed in per-device blocks
        (:func:`placed_decode`).

    Prints one ``phase 15 json`` line; returns the kernel launches of
    (c)'s recorded run."""
    from repro_torch.analysis.recorder import ThreadAccessRecorder
    from repro_torch.configs import get_config
    from repro_torch.dist import collectives
    from repro_torch.dist import flash_decode as FD
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.dist.sharding import lm_cache_specs
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import (forward_prefill, init_cache,
                                                init_lm)
    from repro_torch.serve import (AsyncRetrievalEngine, EngineConfig,
                                   Request, serve_step)
    from repro_torch.serve import engine as engine_mod

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    resident = torch.cuda.memory_allocated() if on_card else 0
    bw, _ = peaks(torch.cuda.get_device_name(0))
    gen = torch.Generator(device=dev)
    summary = {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def event_ms(fn):
        """Device-ordered ms of one call of fn (CUDA events), and its
        result."""
        if not on_card:
            t = time.perf_counter()
            out = fn()
            return (time.perf_counter() - t) * 1e3, out
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), out

    @contextlib.contextmanager
    def split_k(mesh, batch):
        spec = lm_cache_specs(mesh, batch)["pos"]
        FD.configure(mesh, *spec)
        try:
            yield
        finally:
            FD.configure(None, None, None)

    def decode_pair(model, cfg, cache, tok, pos0, steps, mesh, restore):
        """``steps`` greedy plain steps from ``tok`` at ``pos0``, then
        ``restore()`` and the same steps with split-K on ``mesh``,
        teacher-forced on the plain run's tokens: (plain logits, split-K
        logits, plain ms, split-K ms) per step."""
        plain, fd, toks = [], [], [tok]
        with torch.no_grad():
            for t in range(steps):
                ms, (logits, cache) = event_ms(lambda: serve_step(
                    model, cfg, toks[t], pos0 + t, cache))
                plain.append((logits.float(), ms))
                toks.append(torch.argmax(logits, -1).to(torch.int32))
            restore()
            with split_k(mesh, tok.shape[0]):
                for t in range(steps):
                    ms, (logits, cache) = event_ms(lambda: serve_step(
                        model, cfg, toks[t], pos0 + t, cache))
                    fd.append((logits.float(), ms))
        return plain, fd, toks

    def gate(label, plain, fd, names=("split-K", "plain")):
        """Split-K logits within LM_ATOL of the plain run's; greedy ids
        equal wherever the plain top-2 gap exceeds 2 * LM_ATOL. ``names``
        says which runs the two are."""
        err, flips, checked, total = 0.0, 0, 0, 0
        for (p, _), (f, _) in zip(plain, fd):
            if not (torch.isfinite(p).all() and torch.isfinite(f).all()):
                fail(f"phase 15{label}: logits are not finite")
            err = max(err, float((f - p).abs().max()))
            top2 = torch.topk(p, 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * LM_ATOL
            same = torch.argmax(f, -1) == torch.argmax(p, -1)
            checked += int(clear.sum())
            flips += int((clear & ~same).sum())
            total += p.shape[0]
        if err > LM_ATOL or flips:
            fail(f"phase 15{label}: max |{names[0]} - {names[1]}| {err:.3g} "
                 f"(atol {LM_ATOL}), {flips} greedy ids differ")
        print(f"phase 15{label}: {names[0]} logits == {names[1]} within atol "
              f"{LM_ATOL} (max_abs_err {err:.3g}); greedy ids equal on "
              f"{checked} of {total} steps with a top-2 gap > "
              f"{2 * LM_ATOL} [{smi}]", flush=True)
        return err

    # (a) Qwen2.5-3B at long_500k, bf16 ------------------------------------
    cfg = get_config("qwen2.5-3b")
    shape = {s.name: s for s in cfg.shapes}["long_500k"]
    S = cache_slots or shape.seq_len
    B, STEPS = shape.global_batch, 32
    pos0 = S - STEPS
    mesh = make_mesh((1, 4), ("data", "model"), device=dev)

    def filled_cache(dtype):
        """A (B, S) cache with seeded K/V at positions 0 .. pos0 - 1."""
        cache = init_cache(cfg, B, S, dtype, dev)
        st = cache["all"]
        g = torch.Generator(device=dev).manual_seed(11)
        for layer in range(cfg.n_layers):       # one layer's draw at a time
            st.k[layer].normal_(generator=g)
            st.v[layer].normal_(generator=g)
        st.pos[:, :pos0] = torch.arange(pos0, dtype=torch.int32, device=dev)
        return cache

    def reset(cache):
        return lambda: cache["all"].pos[:, pos0:].fill_(-1)

    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = init_lm(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    cache = filled_cache(torch.bfloat16)
    sync()
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    st = cache["all"]
    cache_bytes = 2 * st.k.numel() * st.k.element_size()
    print(f"phase 15a qwen2.5-3b long_500k: B={B}, {S} cache slots in "
          f"bf16 ({cache_bytes / 1e9:.2f} GB K/V, positions 0..{pos0 - 1} "
          f"drawn from seed 11), weights {w_bytes / 1e9:.2f} GB bf16; built "
          f"in {time.perf_counter() - t:.1f} s; split-K mesh {mesh.shape} on "
          f"{dev}, {S // 4} slots a sequence shard [{smi}]", flush=True)
    tok = torch.randint(0, cfg.vocab, (B,), generator=gen.manual_seed(12),
                        device=dev, dtype=torch.int32)
    plain, fd, toks = decode_pair(model, cfg, cache, tok, pos0, STEPS, mesh,
                                  reset(cache))
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    plain_ms = statistics.median(ms for _, ms in plain[1:])
    fd_ms = statistics.median(ms for _, ms in fd[1:])
    dec_bytes = w_bytes - (cfg.vocab - B) * cfg.d_model * 2 + cache_bytes
    bound_ms = dec_bytes / bw * 1e3
    err16 = max(float((f - p).abs().max()) for (p, _), (f, _) in
                zip(plain, fd))
    same16 = sum(int((torch.argmax(f, -1) == torch.argmax(p, -1)).sum())
                 for (p, _), (f, _) in zip(plain, fd))
    if not all(torch.isfinite(x).all() for x, _ in plain + fd):
        fail("phase 15a: bf16 decode logits are not finite")
    print(f"phase 15a decode bf16, {STEPS} steps at positions {pos0}.."
          f"{S - 1}: plain median {plain_ms:.3f} ms a step (min "
          f"{min(ms for _, ms in plain[1:]):.3f}, max "
          f"{max(ms for _, ms in plain[1:]):.3f}); split-K over 4 shards "
          f"{fd_ms:.3f} ms (min {min(ms for _, ms in fd[1:]):.3f}, max "
          f"{max(ms for _, ms in fd[1:]):.3f}); split-K / plain "
          f"{fd_ms / plain_ms:.3f}; bound {bound_ms:.3f} ms by bytes "
          f"({dec_bytes / 1e9:.2f} GB / {bw / 1e12} TB/s); peak memory "
          f"{(peak - resident) / 1e9:.2f} GB above the {resident / 1e9:.2f} "
          f"GB earlier phases hold; bf16 max |split-K - plain| logits "
          f"{err16:.4g}, greedy ids equal on {same16} of {STEPS * B} steps "
          f"(reported; the gate runs in float32 below) [{smi}]", flush=True)
    last = toks[-2]
    with torch.no_grad():
        print(profiled_line("phase 15a plain decode step", lambda: serve_step(
            model, cfg, last, S - 1, cache), plain_ms), f"[{smi}]",
            flush=True)
        with split_k(mesh, B):
            print(profiled_line("phase 15a split-K decode step",
                                lambda: serve_step(model, cfg, last, S - 1,
                                                   cache), fd_ms),
                  f"[{smi}]", flush=True)
    summary["15a"] = dict(
        slots=S, batch=B, steps=STEPS, plain_ms=round(plain_ms, 3),
        split_k_ms=round(fd_ms, 3), bound_ms=round(bound_ms, 3),
        weights_gb=round(w_bytes / 1e9, 3),
        cache_gb=round(cache_bytes / 1e9, 3),
        peak_above_resident_gb=round((peak - resident) / 1e9, 3),
        resident_gb=round(resident / 1e9, 3), bf16_max_abs_err=err16,
        bf16_same_ids=same16)
    del model, cache, plain, fd
    if on_card:
        torch.cuda.empty_cache()

    # the gate, float32 at full depth over the same slots
    t = time.perf_counter()
    model = init_lm(cfg, seed=3, dtype=torch.float32, device=dev)
    cache = filled_cache(torch.float32)
    plain, fd, _ = decode_pair(model, cfg, cache, tok, pos0, 4, mesh,
                               reset(cache))
    summary["15a"]["f32_max_abs_err"] = gate(
        f"a qwen2.5-3b {cfg.n_layers} layers f32, {S} slots, 4 steps", plain,
        fd)
    summary["15a"]["f32_plain_ms"] = round(statistics.median(
        ms for _, ms in plain[1:]), 3)
    summary["15a"]["f32_split_k_ms"] = round(statistics.median(
        ms for _, ms in fd[1:]), 3)
    print(f"phase 15a f32 gate in {time.perf_counter() - t:.1f} s; plain "
          f"{summary['15a']['f32_plain_ms']} ms a step, split-K "
          f"{summary['15a']['f32_split_k_ms']} ms [{smi}]", flush=True)
    del model, cache, plain, fd
    if on_card:
        torch.cuda.empty_cache()
    print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)

    # (a') gemma2-27b, 2 layers, batch blocks ---------------------------------
    gemma = get_config("gemma2-27b")
    g2 = dataclasses.replace(gemma, n_layers=2)
    Bg, Sp = 2, gemma.sliding_window + 4
    max_seq = Sp + 4 + (-(Sp + 4)) % 4           # a multiple of 4 shards
    model = init_lm(g2, seed=4, dtype=torch.float32, device=dev)
    prompt = torch.randint(0, g2.vocab, (Bg, Sp), generator=gen.manual_seed(
        13), device=dev)
    with torch.no_grad():
        last, cache = forward_prefill(model, g2, prompt, max_seq,
                                      cache_dtype=torch.float32)
    saved = {n: tuple(x.clone() for x in st) for n, st in cache.items()}

    def restore():
        for n, st in cache.items():
            for dst, src in zip(st, saved[n]):
                dst.copy_(src)

    mesh2 = make_mesh((2, 4), ("data", "model"), device=dev)
    plain, fd, _ = decode_pair(model, g2, cache,
                               torch.argmax(last, -1).to(torch.int32), Sp,
                               4, mesh2, restore)
    summary["15a'"] = dict(batch=Bg, prompt=Sp, max_seq=max_seq,
                           mesh=mesh2.shape, max_abs_err=gate(
                               f"a' gemma2-27b full width, 2 of "
                               f"{gemma.n_layers} layers f32, B={Bg} on a "
                               f"(2, 4) mesh, prompt {Sp} (ring wraps)",
                               plain, fd))
    del model, cache, saved, plain, fd, last
    if on_card:
        torch.cuda.empty_cache()
    print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)

    # (b) ring collectives on 4 shards of the card -------------------------
    ring = make_mesh((4,), ("model",), device=dev)
    hops = []
    noted = collectives.note_collective

    def note(kind, nb):
        hops.append((kind, nb))
        noted(kind, nb)

    gb = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn((4 * 2048, 2048), generator=gb, device=dev).to(
        torch.bfloat16)
    xm = torch.randn((8192, 2048), generator=gb, device=dev).to(
        torch.bfloat16)
    w = torch.randn((2048, 11008), generator=gb, device=dev).to(
        torch.bfloat16)
    collectives.note_collective = note
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        gathered = collectives.ring_all_gather(list(x.chunk(4)), ring)
        gather_hops = list(hops)
        del hops[:]
        products = collectives.ring_matmul(list(xm.chunk(4)), w, ring)
        matmul_hops = list(hops)
        # warm: the first calls above also grew the allocator's pool
        ms_g = statistics.median(event_ms(lambda: collectives.ring_all_gather(
            list(x.chunk(4)), ring))[0] for _ in range(3))
        ms_m = statistics.median(event_ms(lambda: collectives.ring_matmul(
            list(xm.chunk(4)), w, ring))[0] for _ in range(3))
    finally:
        collectives.note_collective = noted
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced
    if len(gathered) != 4 or not all(torch.equal(g, x) for g in gathered):
        fail("phase 15b: ring_all_gather differs from torch.cat")
    want = (xm @ w).float()
    err_m = 0.0
    for p in products:
        d = (p.float() - want).abs()
        if bool((d > RING_RTOL * want.abs() + RING_ATOL).any()):
            fail(f"phase 15b: ring_matmul beyond {RING_RTOL} x |x @ w| + "
                 f"{RING_ATOL} (max |diff| {float(d.max()):.4g})")
        err_m = max(err_m, float(d.max()))
    if len(gather_hops) != 3 or len(matmul_hops) != 3:
        fail(f"phase 15b: hops noted {gather_hops} / {matmul_hops}")
    summary["15b"] = dict(
        gather_hop_bytes=[nb for _, nb in gather_hops],
        matmul_hop_bytes=[nb for _, nb in matmul_hops],
        gather_ms=round(ms_g, 3), matmul_ms=round(ms_m, 3),
        matmul_max_abs_err=err_m)
    print(f"phase 15b ring_all_gather of (4 x 2048, 2048) bf16 on 4 shards "
          f"of {dev}: every shard == torch.cat bit for bit, 3 hops of "
          f"{gather_hops[0][1]} bytes noted ({gather_hops[0][0]}), "
          f"{ms_g:.3f} ms warm (median of 3); ring_matmul (8192, 2048) x "
          f"(2048, 11008) bf16: "
          f"every shard == x @ w within {RING_RTOL} x |x @ w| + {RING_ATOL} "
          f"(max |diff| {err_m:.4g}), 3 hops of {matmul_hops[0][1]} bytes, "
          f"{ms_m:.3f} ms [{smi}]", flush=True)
    del x, xm, w, want, gathered, products
    print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)

    # (c) the thread-access recorder on the continuous engine ---------------
    nq, T, _ = ds.queries.shape
    ecfg = EngineConfig(batch_size=nq, deadline_s=30.0, token_buckets=(T,),
                        cand_buckets=(64, MAX_CANDIDATES), max_k=K,
                        flavor="auto", bandit_min_candidates=MAX_CANDIDATES,
                        stage1_candidates=MAX_CANDIDATES, stage1_kprime=10,
                        seed=SEED, continuous=True)
    ids = [r[r >= 0] for r in cand.doc_ids.cpu().numpy()]

    def requests():
        return ([Request(query=ds.queries[i], k=K, cand_ids=ids[i])
                 for i in range(nq)]
                + [Request(query=ds.queries[i], k=K, cand_ids=ids[i][:64])
                   for i in range(nq)]
                + [Request(query=ds.queries[i], k=K) for i in range(nq)])

    def serve(recorded):
        eng = AsyncRetrievalEngine(index.doc_embs, index.doc_mask, ecfg,
                                   device=dev)
        eng.warmup()
        rec = (ThreadAccessRecorder(eng, declared=set(engine_mod.GUARDED_BY))
               if recorded else contextlib.nullcontext())
        reqs = requests()
        _build.reset_launches()
        t = time.perf_counter()
        with rec:
            with eng:
                for r in reqs:
                    eng.submit(r)
                done = eng.drain()
        sync()
        secs = time.perf_counter() - t
        counts = {k: v for k, v in _build.LAUNCHES.items() if v}
        got = {c.rid: c for c in done}
        if not len(got) == len(done) == len(reqs):
            fail(f"phase 15c: {len(done)} completions for {len(reqs)}")
        return got, (rec if recorded else None), counts, secs

    t = time.perf_counter()
    plain_c, _, _, secs0 = serve(False)
    got_c, rec, served, secs1 = serve(True)
    secs_c = time.perf_counter() - t
    bad = [rid for rid, c in plain_c.items() if not (
        rid in got_c and np.array_equal(c.topk_ids, got_c[rid].topk_ids)
        and np.array_equal(c.topk_scores, got_c[rid].topk_scores)
        and c.reveal_fraction == got_c[rid].reveal_fraction)]
    if bad or len(got_c) != len(plain_c):
        fail(f"phase 15c: rids {bad} differ under the recorder")
    if rec.violations():
        fail(f"phase 15c: recorder violations {rec.violations()}")
    if not served.get("fused_reveal"):
        fail(f"phase 15c: launches {served}")
    shared = sorted(rec.shared())
    summary["15c"] = dict(requests=len(got_c), shared_attrs=len(shared),
                          violations=0, launches=served,
                          secs_unrecorded=round(secs0, 3),
                          secs_recorded=round(secs1, 3))
    print(f"phase 15c ThreadAccessRecorder on the continuous "
          f"AsyncRetrievalEngine, phase 4's f32 corpus: {len(got_c)} "
          f"requests, violations() == [], {len(shared)} attributes touched "
          f"by >= 2 threads, all declared; completions == an unrecorded "
          f"engine's bit for bit (ids, scores, reveal fractions); "
          f"{secs1:.2f} s recorded, {secs0:.2f} s unrecorded ({secs_c:.1f} s "
          f"with both engines' warmup); launches {served} [{smi}]",
          flush=True)

    print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)

    # (d) split-K over per-device cache blocks ------------------------------
    summary["15d"] = placed_decode(dev, smi, event_ms, gate, split_k,
                                   cache_slots)

    print(f"phase 15 json {json.dumps(summary)}", flush=True)
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s; elapsed "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    return served



def placed_decode(dev, smi, event_ms, gate, split_k, cache_slots=0):
    """15(d). Split-K decode over a KV cache placed in per-device blocks:
    Qwen2.5-3B at full width cut to 2 of 36 layers, float32, B = 1, a
    65,536-slot cache (``cache_slots`` overrides it for a rehearsal) on a
    (1, 4) ("data", "model") mesh whose shards are ``dev`` x 2 and, on a
    host with two cards, ``cuda:1`` x 2, else the CPU x 2 (``cpu:0`` off
    the card). The cache's bytes on each device are checked exactly (its
    two of four sequence blocks of every stack, and on a card the
    allocator's count when the zeros are placed). Then a 4,096-token
    prefill (slots / 16) into the placed cache; the slots after it up to
    the last 8 take K/V drawn from a seed (as 15(a)'s), so every sequence
    block, the second device's included, holds live slots; and 8 greedy
    split-K steps at the last 8 positions, against the same steps on a
    one-device (1, 4) mesh of ``dev`` over the same cache (teacher-forced
    on that run's tokens): logits within LM_ATOL, greedy ids equal
    wherever the one-device top-2 gap exceeds 2 * LM_ATOL (phase 12's
    rule); ms a step (CUDA events, median of steps 2-8) beside the
    one-device split-K's."""
    from repro_torch.configs import get_config
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.models.transformer import (forward_prefill, init_cache,
                                                init_lm)
    from repro_torch.serve import serve_step

    t = time.perf_counter()
    on_card = dev.type == "cuda"
    if on_card and torch.cuda.device_count() >= 2:
        other, where = torch.device("cuda", 1), "cuda:1 (a second card)"
    elif on_card:
        other, where = torch.device("cpu"), "the CPU (one card on the host)"
    else:
        other, where = torch.device("cpu", 0), "cpu:0 (a rehearsal)"
    full = get_config("qwen2.5-3b")
    cfg = dataclasses.replace(full, n_layers=2)
    S = cache_slots or 65536
    P, B, STEPS = S // 16, 1, 8
    one = make_mesh((1, 4), ("data", "model"), device=dev)
    spread = make_mesh((1, 4), ("data", "model"),
                       devices=[dev, dev, other, other])
    dev, other = spread.devices[0], spread.devices[2]   # with their index

    def held_by(cache):
        held = {dev: 0, other: 0}
        for st in cache.values():
            for blocks in st:
                for d, nb in blocks.bytes_by_device().items():
                    held[d] += nb
        return held

    def allocated():
        return {d: torch.cuda.memory_allocated(d) for d in (dev, other)
                if d.type == "cuda"}

    # the bytes each device holds: 2 of 4 sequence blocks of k, v and pos
    kv = cfg.n_layers * B * S * cfg.n_kv_heads * cfg.d_head * 4
    share = (2 * kv + B * S * 4) // 2
    before = allocated()
    cache = init_cache(cfg, B, S, torch.float32, mesh=spread)
    after = allocated()
    held = held_by(cache)
    if held != {dev: share, other: share}:
        fail(f"phase 15d: cache bytes by device {held}, want {share} on "
             f"each of {dev} and {other}")
    grown = {d: after[d] - before[d] for d in after}
    if any(n != share for n in grown.values()):
        fail(f"phase 15d: the allocator grew by {grown} placing the cache, "
             f"want {share} a card")
    del cache

    model = init_lm(cfg, seed=5, dtype=torch.float32, device=dev)
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=torch.Generator(
        device=dev).manual_seed(15), device=dev)
    pos0 = S - STEPS

    def draw(cache):
        """Seeded K/V at positions P .. pos0 - 1 of every layer, through
        each placed stack's gathered layer (the same values in any
        layout)."""
        g = torch.Generator(device=dev).manual_seed(17)
        for st in cache.values():
            for layer in range(st.k.shape[0]):
                for blocks in (st.k, st.v):
                    whole = blocks[layer].gather()
                    whole[:, P:pos0].normal_(generator=g)
                    blocks[layer] = whole
            pos = st.pos.gather()
            pos[:, P:pos0] = torch.arange(P, pos0, dtype=torch.int32,
                                          device=pos.device)
            st.pos.copy_(pos)

    with torch.no_grad():
        p_ms, (last, cache1) = event_ms(lambda: forward_prefill(
            model, cfg, prompt, S, torch.float32, mesh=one))
        draw(cache1)
    tok = torch.argmax(last, -1).to(torch.int32)

    def decode(cache, mesh, feed=None):
        """STEPS split-K steps on ``mesh``: greedy from ``tok``, or fed
        ``feed``; (logits, ms) per step and the tokens."""
        out, toks = [], [tok]
        with torch.no_grad(), split_k(mesh, B):
            for i in range(STEPS):
                cur = toks[i] if feed is None else feed[i]
                ms, (logits, cache) = event_ms(lambda: serve_step(
                    model, cfg, cur, pos0 + i, cache))
                out.append((logits.float(), ms))
                toks.append(torch.argmax(logits, -1).to(torch.int32))
        return out, toks

    ref, toks = decode(cache1, one)
    del cache1
    with torch.no_grad():
        s_ms, (last2, cache2) = event_ms(lambda: forward_prefill(
            model, cfg, prompt, S, torch.float32, mesh=spread))
        draw(cache2)
    held2 = held_by(cache2)
    if held2 != held:
        fail(f"phase 15d: the prefilled cache holds {held2}, want {held}")
    for st in cache2.values():            # every block attends over slots
        if not all(bool((st.pos.parts[i] >= 0).any())
                   for i in st.pos.stored()):
            fail("phase 15d: a sequence block holds no live slot")
    got, _ = decode(cache2, spread, toks)
    err = gate(f"d qwen2.5-3b full width, 2 of {full.n_layers} layers f32, "
               f"{S} slots on {dev} x 2 + {other} x 2 vs one device, "
               f"prefill {P}, drawn to {pos0 - 1}, {STEPS} steps", ref, got,
               ("placed split-K", "one-device split-K"))
    perr = float((last2.float() - last.float()).abs().max())
    if perr > LM_ATOL:
        fail(f"phase 15d: prefill logits differ by {perr:.3g}")
    one_ms = statistics.median(ms for _, ms in ref[1:])
    spread_ms = statistics.median(ms for _, ms in got[1:])
    out = dict(slots=S, prompt=P, steps=STEPS, first_position=pos0,
               other=str(other),
               bytes_by_device={str(d): n for d, n in held.items()},
               allocator_growth={str(d): n for d, n in grown.items()},
               one_device_ms=round(one_ms, 3), placed_ms=round(spread_ms, 3),
               prefill_ms_one=round(p_ms, 3), prefill_ms_placed=round(s_ms, 3),
               max_abs_err=err, prefill_max_abs_err=perr)
    print(f"phase 15d placed cache on {dev} x 2 + {where} x 2: "
          f"{held[dev]} / {held[other]} bytes of cache on {dev} / {other} "
          f"(exact: 2 of 4 sequence blocks each; allocator growth {grown}); "
          f"prefill {P} tokens {s_ms:.3f} ms (one device {p_ms:.3f}); "
          f"K/V drawn at positions {P}..{pos0 - 1}; split-K decode at "
          f"{pos0}..{S - 1} {spread_ms:.3f} ms a step (median of steps 2-"
          f"{STEPS}; min {min(ms for _, ms in got[1:]):.3f}, max "
          f"{max(ms for _, ms in got[1:]):.3f}) beside one-device split-K "
          f"{one_ms:.3f} ms; max |placed - one device| logits {err:.3g}; "
          f"{time.perf_counter() - t:.1f} s [{smi}]", flush=True)
    del model, cache2
    if on_card:
        torch.cuda.empty_cache()
    return out


def launcher_account(dev, smi, t_start):
    """16. The launcher's per-device account (``repro_torch.launch``), on the
    host and held against the card.

    (a) The account (``launch/dryrun.py::run_cell``: exact placement bytes,
        FLOPs and bytes counted over the port's step on ``meta``, reckoned
        collectives, the H100's roofline seconds) of one cell per family on
        the (16, 16) production mesh at full depth, on this machine's host:
        ``qwen2.5-3b`` / ``moonshot-v1-16b-a3b`` ``decode_32k``, ``pna
        ogb_products``, ``fm serve_bulk`` and ``colbert-text rerank_bulk``;
        each record printed whole.
    (b) Three cells on a one-card mesh (``make_host_mesh(1)``), their
        arguments drawn (seeded) on the card at the cell's shapes:
        ``qwen2.5-3b decode_32k`` at ``depth=2`` with its full B = 128 and
        32,768-slot bf16 cache; ``colbert-text rerank_online`` (B = 256, N
        = 256, 1,024 candidate slots) over phase 4's 65,536-doc count in
        bf16 (``corpus_docs``); ``pna molecule`` at full size, a train
        step. Each must hold (i) the account's argument bytes == the summed
        ``nbytes`` of the arguments on the card, (ii) for the LM and PNA
        cells the counted ``meta`` FLOPs == ``FlopCounterMode`` over the
        card's run of the same step, (iii) for the retrieval cell
        ``colbandit_maxsim`` launched (wrapper counts, as phase 10a counts
        them) as often as the account expects, and the step's top-10
        scores and ids equal a plain rerank of the same tensors (the
        candidates gathered, ``maxsim_batch_plain`` over chunks of 16
        queries, the masked sum, ``stable_topk``): scores within RTOL /
        ATOL, ids wherever the neighbouring scores are further apart than
        that, and the kernel's (B, 1,024, T) result at the step's launch
        shape (pad slots included) within RTOL / ATOL of the plain one
        (check launches, made after the counts are read); reported: (iv)
        the step's
        CUDA-event median ms beside the account's max(compute_s, memory_s)
        and their ratio, (v) ``max_memory_allocated`` above the arguments
        beside the account's eager live peak.

    Prints one ``phase 16 json`` line; returns the kernel launches of
    (b)'s runs of the retrieval step."""
    import collections

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis.accounting import placed_leaves
    from repro_torch.configs import get_config
    from repro_torch.core.bandit import stable_topk
    from repro_torch.kernels import _build
    from repro_torch.kernels.maxsim import maxsim_batch_plain
    from repro_torch.kernels.ops import maxsim_batch_op
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as launch_steps
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.models.gnn import GraphBatch, init_pna
    from repro_torch.models.transformer import init_cache, init_lm
    from repro_torch.retrieval.service import gather_candidates
    from repro_torch.train.optimizer import adamw, cosine_schedule
    from repro_torch.train.train_step import init_train_state

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    summary = {"16a": {}, "16b": {}}
    served = collections.Counter()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # (a) the account on the host ------------------------------------------
    prod = make_production_mesh()
    for arch, shape in (("qwen2.5-3b", "decode_32k"),
                        ("moonshot-v1-16b-a3b", "decode_32k"),
                        ("pna", "ogb_products"), ("fm", "serve_bulk"),
                        ("colbert-text", "rerank_bulk")):
        rec = dryrun.run_cell(arch, shape, prod, verbose=False)
        r = rec["reckoned"]
        summary["16a"][f"{arch} {shape}"] = dict(
            account_s=round(rec["account_s"], 3),
            bottleneck=rec["bottleneck"], compute_s=r["compute_s"],
            memory_s=r["memory_s"], collective_s=r["collective_s"],
            useful_flops_frac=r["useful_flops_frac"])
        print(f"phase 16a record {json.dumps(rec)}", flush=True)
    print(f"phase 16a: 5 cells accounted on the (16, 16) mesh at full depth "
          f"in {time.perf_counter() - t_phase:.1f} s", flush=True)

    # (b) the account held against the card ---------------------------------
    mesh = make_host_mesh(1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(16)

    def randint(hi, shape, dtype=torch.int32):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    def step_ms(fn, reps=5):
        if not on_card:
            t = time.perf_counter()
            fn()
            return (time.perf_counter() - t) * 1e3
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def held(arch, shape, overrides, make_args, kernel=None, check=None):
        rec = dryrun.run_cell(arch, shape, mesh, verbose=False, **overrides)
        cell = launch_steps.build_cell(arch, shape, mesh, **overrides)
        real = make_args(cell)
        want = placed_leaves(cell.args, cell.in_specs)
        got = placed_leaves(real, cell.in_specs)
        bad = [(p, tuple(a.shape), a.dtype, tuple(b.shape), b.dtype)
               for (p, a, _), (_, b, _) in zip(want, got)
               if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype]
        if len(want) != len(got) or bad:
            fail(f"phase 16b {arch} {shape}: arguments differ from the "
                 f"cell's: {bad[:3]}")
        nbytes = sum(t.numel() * t.element_size() for _, t, _ in got)
        acct = rec["exact"]["argument_bytes_per_device"]
        if nbytes != acct:
            fail(f"phase 16b {arch} {shape} (i): {nbytes} argument bytes on "
                 f"the card, the account says {acct}")
        sync()
        base = torch.cuda.memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        with FlopCounterMode(display=False) as fc:
            out = cell.fn(*real)
        sync()
        once = {k: v for k, v in _build.LAUNCHES.items() if v}
        peak = (torch.cuda.max_memory_allocated() - base) if on_card else 0
        card_flops = int(fc.get_total_flops())
        counted = (rec["counted"] or {}).get("counted_flops")
        if counted is not None and card_flops != counted:
            fail(f"phase 16b {arch} {shape} (ii): FlopCounterMode on the "
                 f"card {card_flops}, counted on meta {counted}")
        if kernel:
            work = rec["reckoned"]["kernel_work"]
            expect = work["kernel_launches_per_device"][kernel] * mesh.size
            if once.get(kernel, 0) != expect:
                fail(f"phase 16b {arch} {shape} (iii): launches {once}, the "
                     f"account expects {expect} {kernel}")
        ms = step_ms(lambda: cell.fn(*real))
        sync()
        if kernel:
            served.update({k: v for k, v in _build.LAUNCHES.items() if v})
        plain = check(real, out) if check else None
        r = rec["reckoned"]
        bound = max(r["compute_s"], r["memory_s"]) * 1e3
        live = (rec["counted"] or {}).get("eager_live_peak_bytes_per_device")
        summary["16b"][f"{arch} {shape}"] = dict(
            argument_bytes=nbytes, card_flops=card_flops,
            counted_flops=counted, launches=once, plain=plain,
            ms=round(ms, 4), account_ms=round(bound, 4),
            ratio=round(ms / bound, 3) if bound else None,
            peak_above_args=peak, eager_live_peak=live)
        print(f"phase 16b {arch} {shape} {overrides}: (i) argument bytes "
              f"{nbytes} == the account's; (ii) FLOPs card {card_flops} / "
              f"meta {counted}; (iii) launches {once}, against the plain "
              f"version {plain}; (iv) {ms:.3f} ms a "
              f"step (median of 5, CUDA events) vs the account's "
              f"max(compute, memory) {bound:.3f} ms (memory_s an unfused "
              f"upper bound): ratio "
              f"{(ms / bound if bound else float('nan')):.2f}; (v) peak "
              f"{peak / 1e9:.3f} GB above the arguments, eager live peak "
              f"{(live or 0) / 1e9:.3f} GB [{smi}]", flush=True)
        del real, out
        if on_card:
            torch.cuda.empty_cache()

    def rerank_plain(real, out, chunk=16):
        """The step's (scores, ids) against a plain rerank of ``real`` on
        the one shard, and the kernel's H at the step's launch shape
        against ``maxsim_batch_plain``; fails on a mismatch."""
        embs, mask, q, cand = real
        c = cand[:, 0].to(torch.int64)
        docs, dmask = gather_candidates(embs, mask, c)
        h = maxsim_batch_op(docs, dmask, q)
        h_plain = torch.cat([
            maxsim_batch_plain(docs[i:i + chunk], dmask[i:i + chunk],
                               q[i:i + chunk])
            for i in range(0, c.shape[0], chunk)])
        del docs
        err_h = check_close("phase 16b maxsim at the cell's shape", h,
                            h_plain)
        sc = torch.where(dmask.any(dim=2)[:, :, None], h_plain,
                         0.0).sum(dim=-1)
        sc = torch.where(c >= 0, sc, -3e38)
        k = out[0].shape[1]
        best, pos = stable_topk(sc, k + 1)
        ids = torch.where(best > -1.5e38, torch.gather(c, 1, pos), -1)
        err_s = check_close("phase 16b top-K scores", out[0], best[:, :k])
        tol = ATOL + RTOL * best.abs()
        gap = best[:, :-1] - best[:, 1:]            # to the next one down
        up = torch.cat([torch.full_like(gap[:, :1], float("inf")),
                        gap[:, :-1]], dim=1)        # to the next one up
        decided = (gap > tol[:, :k]) & (up > tol[:, :k])
        wrong = decided & (out[1].to(torch.int64) != ids[:, :k])
        if bool(wrong.any()):
            b, j = (int(v) for v in wrong.nonzero()[0])
            fail(f"phase 16b rerank: query {b} rank {j} id "
                 f"{int(out[1][b, j])}, the plain rerank's "
                 f"{int(ids[b, j])} (scores {best[b, :k].tolist()})")
        return dict(maxsim_max_abs_err=err_h, score_max_abs_err=err_s,
                    ids_decided=int(decided.sum()), ids=decided.numel())

    def lm_args(cell):
        params, tok, _, cache = cell.args
        model = init_lm(params.cfg, seed=SEED, dtype=torch.bfloat16,
                        device=dev)
        B, S = tok.shape[0], next(iter(cache.values())).pos.shape[1]
        real_cache = init_cache(params.cfg, B, S, torch.bfloat16, dev)
        for st in real_cache.values():
            for t in (st.k, st.v):
                for i in range(t.shape[0]):
                    t[i].normal_(generator=gen)
            st.pos.copy_(torch.arange(st.pos.shape[1], dtype=torch.int32,
                                      device=dev).expand_as(st.pos))
        return (model, randint(params.cfg.vocab, (B,)),
                torch.tensor(S - 1, dtype=torch.int32, device=dev),
                real_cache)

    def rerank_args(cell):
        embs, mask, queries, cand = cell.args
        C, L, M = embs.shape
        e = torch.empty((C, L, M), dtype=torch.bfloat16, device=dev)
        for i in range(0, C, 8192):         # unit rows, as served tokens
            x = torch.randn((min(8192, C - i), L, M), generator=gen,
                            device=dev)
            e[i:i + 8192] = x / x.norm(dim=-1, keepdim=True)
        lens = randint(L - L // 4, (C,)) + L // 4
        m = torch.arange(L, device=dev)[None, :] < lens[:, None]
        q = torch.randn(tuple(queries.shape), generator=gen, device=dev)
        q = (q / q.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
        c = randint(C, tuple(cand.shape))
        n = next(s for s in get_config("colbert-text").shapes
                 if s.name == "rerank_online").n_candidates
        c[..., n:] = -1                  # the routing headroom's pad slots
        return (e, m, q, c)

    def pna_args(cell):
        _, batch = cell.args
        n, d_feat = batch.feats.shape
        e = batch.senders.shape[0]
        cfg = get_config("pna")
        params = init_pna(cfg, d_feat, seed=SEED, device=dev)
        state = init_train_state(params,
                                 adamw(cosine_schedule(1e-3, 100, 10_000)))
        shape = next(s for s in cfg.shapes if s.name == "molecule")
        real_edges = shape.graph_batch * shape.n_edges
        return state, GraphBatch(
            feats=torch.randn((n, d_feat), generator=gen, device=dev),
            senders=randint(n, (e,)), receivers=randint(n, (e,)),
            edge_mask=torch.arange(e, device=dev) < real_edges,
            node_mask=torch.ones(n, dtype=torch.bool, device=dev),
            labels=randint(cfg.n_classes, (n,)))

    held("qwen2.5-3b", "decode_32k", {"depth": 2}, lm_args)
    held("colbert-text", "rerank_online",
         {"corpus_docs": CORPUS["n_docs"]}, rerank_args, kernel="maxsim",
         check=rerank_plain)
    held("pna", "molecule", {}, pna_args)
    if not served.get("maxsim"):
        fail(f"phase 16b: maxsim never launched ({dict(served)})")
    print(f"phase 16 json {json.dumps(summary)}", flush=True)
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s; elapsed "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
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
    # (B*T, M) query tokens, frontier rows F with G tokens each. G = 96 and
    # 128 draw from one query of T = 128 tokens (the kernels walk G in
    # chunks of 64 rows).
    D, TQ, T_LONG = 16 * 256, 16 * 32, 128
    reveal_cases = [("round", 128, 8, 128, 128, torch.float32, "random"),
                    ("init", 4096, 1, 128, 128, torch.float32, "random"),
                    ("bf16", 128, 8, 128, 128, torch.bfloat16, "random"),
                    ("F=1", 1, 8, 128, 128, torch.float32, "random"),
                    ("odd", 37, 3, 77, 100, torch.float32, "random"),
                    ("new-none", 128, 8, 128, 128, torch.float32, "none"),
                    ("G=64", 64, 64, 128, 128, torch.float32, "random"),
                    ("G=96", 96, 96, 128, 128, torch.float32, "random"),
                    ("G=128", 32, 128, 128, 128, torch.float32, "random"),
                    ("G=128 bf16", 32, 128, 77, 100, torch.bfloat16,
                     "random")]
    for label, F, G, L, M, dt, fresh in reveal_cases:
        e, m = corpus_like(gen, D, L, M, dt, min(32, L), dead=(3, 5))
        tq = T_LONG if G > 64 else TQ
        qt = unit_rows(gen, (tq, M)).to(dt)
        sets = []
        for _ in range(8):   # rotate selections so a launch finds its docs cold
            di = torch.randint(0, D, (F,), generator=gen, device="cuda")
            di[0] = 3                                   # an all-masked doc
            ti = torch.randint(0, tq, (F, G), generator=gen, device="cuda")
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
        it = [0]

        def nxt():
            it[0] += 1
            return sets[it[0] % len(sets)]

        if label in ("G=64", "G=96", "G=128"):   # ceil(G / 64) doc walks
            dms = device_ms(lambda: fused_reveal_cuda(e, m, qt, *nxt()),
                            "reveal_kernel<DenseRows")
            print(f"timing fused_reveal {label} F={F}: cold device {dms:.4f} "
                  f"ms, {dms / F * 1e3:.3f} us per frontier row [{smi}]",
                  flush=True)
        if label not in ("round", "init"):
            continue

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
    lo, hi = 0.0092, 0.0101      # PERF.md: the round before G chunks, cold ms
    for kname in ("fused_reveal", "gather_maxsim"):
        dms = records[kname]["device_ms"]
        print(f"phase 3 round launch (F=128, G=8) {kname}: cold device "
              f"{dms:.4f} ms against PERF.md's {lo}-{hi} (within 10 %: "
              f"{0.9 * lo <= dms <= 1.1 * hi}) [{smi}]", flush=True)

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

    # Kc = 1,024 is beyond the codebook either layout stages: the kernels
    # read it from global memory.
    q_formats = [("int8", 0), ("residual", 8), ("residual", 1),
                 ("residual", 1024)]
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
                      ("G=64", 64, 64, 128, 128, "random"),
                      ("G=96", 96, 96, 128, 128, "random"),
                      ("G=128", 32, 128, 77, 100, "random")]
    for fmt, Kc in q_formats:
        for label, F, G, L, M, fresh in reveal_q_cases:
            if Kc == 1 and label not in ("odd", "round"):
                continue
            if Kc == 1024 and label in ("F=1", "new-none", "G=64"):
                continue
            qt, m = quant_like(D, L, M, fmt, Kc, dead=(3, 5))
            dense = dequantize(qt)
            tq = T_LONG if G > 64 else TQ
            qtab = unit_rows(gen, (tq, M))
            sets = []
            for _ in range(8):
                di = torch.randint(0, D, (F,), generator=gen, device="cuda")
                di[0] = 3                               # an all-masked doc
                ti = torch.randint(0, tq, (F, G), generator=gen,
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

    # A staged codebook's cost: the residual round launch at Kc = 256 (a
    # 135 KB codebook, staged by every block) beside Kc = 8 and 1,024 above.
    qt, m = quant_like(D, 128, 128, "residual", 256, dead=(3, 5))
    qtab = unit_rows(gen, (TQ, 128))
    sets = [(torch.randint(0, D, (128,), generator=gen, device="cuda"),
             torch.randint(0, TQ, (128, 8), generator=gen, device="cuda"),
             torch.rand((128, 8), generator=gen, device="cuda") < 0.7)
            for _ in range(8)]
    vals, stats = fused_reveal_q_cuda(qt, m, qtab, *sets[0])
    if not torch.equal(vals, fused_reveal_cuda(dequantize(qt), m, qtab,
                                               *sets[0])[0]):
        fail("residual Kc=256: fused_reveal_q differs from its f32 twin")
    it = [0]

    def nxt256():
        it[0] += 1
        return sets[it[0] % len(sets)]

    dms = device_ms(lambda: fused_reveal_q_cuda(qt, m, qtab, *nxt256()),
                    "reveal_kernel<QuantRows")
    print(f"timing fused_reveal_q residual Kc=256 (staged) round F=128 G=8: "
          f"cold device {dms:.4f} ms; == its f32 twin bit for bit [{smi}]",
          flush=True)

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
    res5, step_ms5 = {}, {}
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
            step_ms5[fmt, label] = step_ms
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
    print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
    # 10. sharded serving ------------------------------------------------------
    served = sharded_serving(
        torch.device("cuda"), index, ds, cand,
        (out["dense"].topk_scores, out["dense"].topk_ids),
        res5["int8", "dense"],
        {fmt: step_ms5[fmt, "pooled"] for fmt in ("f32", "int8")},
        profiled_line, smi, t_start)
    print(f"phase 10: launches in the served runs {dict(served)}",
          flush=True)
    for kname in ("maxsim", "maxsim_q", "gather_maxsim", "fused_reveal",
                  "fused_reveal_q"):
        if not served.get(kname):
            fail(f"phase 10: {kname} never launched on the sharded paths")
    for kname, n in served.items():
        records[kname]["launches"] += n
    print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
    # 11. launch-shape tuning and the serving-contract audit ----------------
    served = tuning_and_audit(torch.device("cuda"), index, ds, cand, smi,
                              t_start)
    print(f"phase 11: launches in the served run {dict(served)}",
          flush=True)
    for kname, n in served.items():
        records[kname]["launches"] += n
    print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
    # 12. LM serving and the late-interaction encoder -------------------------
    served = lm_serving(torch.device("cuda"), profiled_line, smi, t_start)
    print(f"phase 12: launches in the served runs {dict(served)}",
          flush=True)
    for kname, n in served.items():
        records[kname]["launches"] += n
    print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
    # 13. MoE backbones, recsys and the generalized Col-Bandit --------------
    torch.cuda.empty_cache()              # phase 12's models and caches
    served = moe_and_recsys(torch.device("cuda"), profiled_line, smi,
                            t_start)
    print(f"phase 13: launches in the served runs {dict(served)}",
          flush=True)
    for kname, n in served.items():
        records[kname]["launches"] += n
    print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
    # 14. training ------------------------------------------------------------
    torch.cuda.empty_cache()              # phase 13's Moonlight
    training(torch.device("cuda"), profiled_line, smi, t_start)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
    # 15. long-context decode, ring collectives, the recorder -----------------
    torch.cuda.empty_cache()              # phase 14's training state
    served = long_context(torch.device("cuda"), index, ds, cand,
                          profiled_line, smi, t_start)
    print(f"phase 15: launches in the served runs {dict(served)}",
          flush=True)
    for kname, n in served.items():
        records[kname]["launches"] += n
    print(f"elapsed {time.perf_counter() - t_start:.1f} s", flush=True)
    # 16. the launcher's account, on the host and against the card ----------
    torch.cuda.empty_cache()              # phase 15's long-context cache
    served = launcher_account(torch.device("cuda"), smi, t_start)
    print(f"phase 16: launches in the served runs {dict(served)}",
          flush=True)
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


def train_resume_main() -> int:
    """``--train-resume``: phase 14(c) alone, in its own process, with
    deterministic algorithms (the parent sets CUBLAS_WORKSPACE_CONFIG)."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    res = train_resume_check(torch.device("cuda"))
    print("train-resume " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--train-resume"]:
        sys.exit(train_resume_main())
    sys.exit(main())
