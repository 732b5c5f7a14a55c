"""The readers of the program's own spans, counters and collector pauses,
on hand-made runs (each against its hand-computed value, and None where
the program records none, as before it had spans); and the program's
stage-1 span inside the harness's span of the same call."""
import types

import numpy as np
import pytest
import torch

from perfbench.harness import program_spans as ps
from perfbench.harness import spec
from perfbench.harness.context import Run
from perfbench.harness.trace import DeviceOp, HostSpans, Trace
from repro_torch import spans
from repro_torch.serve import BatchRecord

MS = 1_000_000
OFF = 10 ** 18          # time.time_ns() - perf_counter_ns(), pinned


@pytest.fixture(autouse=True)
def _offset(monkeypatch):
    monkeypatch.setattr(ps, "clock_offset_ns", lambda: OFF)


def _batch(flavor="dense", trips=0, wait=0, loop=0, **span_ms):
    """A record whose spans are ``name=(start ms, end ms)`` after OFF."""
    st = spans.new()
    for name, (s, e) in span_ms.items():
        at = 3 * spans.SPANS.index(name)
        st[at], st[at + 1], st[at + 2] = 1, OFF + s * MS, OFF + e * MS
    st[spans.TRIPS], st[spans.WAIT_NS], st[spans.LOOP_NS] = trips, wait, loop
    return BatchRecord(bucket=(32, 64), flavor=flavor, n_real=1,
                       occupancy=1.0, service_s=0.0, reveal_fraction=1.0,
                       stamps=st)


def _run(batches, trace=None, profiled=None, t0=0.0, t_end=1.0):
    return Run(cell=None, seed=0, seconds=t_end - t0, setup_s=0.0, t0=t0,
               t_end=t_end, records=[], batches=list(batches), n_served=0,
               launches={}, trace=trace, memory_peak_bytes=0, inputs=None,
               profiled=profiled)


def _trace(on_ms, t1_ms, busy_ms=()):
    return Trace(t0=OFF + on_ms * MS, t1=OFF + t1_ms * MS,
                 ops=[DeviceOp("k", OFF + s * MS, OFF + e * MS)
                      for s, e in busy_ms],
                 spans=[], on=OFF + on_ms * MS)


def read(name, run):
    return spec.reader(name).read(run)


def test_idle_in_engine_counts_idle_time_under_engine_spans():
    # Sub-window 100-200 ms; the device is busy 110-120 and 150-160.
    tr = _trace(100, 200, busy_ms=[(110, 120), (150, 160)])
    bs = [_batch(admit=(90, 105), step=(105, 115), harvest=(118, 125),
                 queued=(125, 180)),          # queued is not an engine span
          _batch(deliver=(170, 190), held=(190, 195))]
    # Idle: 100-110, 120-150, 160-200. Engine spans: 90-115, 118-125,
    # 170-190. Idle under them: 100-110, 120-125, 170-190 = 35 ms of 100.
    assert read("idle_in_engine_pct.qps", _run(bs, tr)) == \
        pytest.approx(35.0)
    assert read("idle_in_engine_pct.qps", _run(bs)) is None     # untraced


def test_span_means_leave_out_batches_outside_the_window_or_profiled():
    bs = [_batch(admit=(10, 12), step=(12, 20), held=(20, 24)),
          _batch(admit=(30, 36), step=(36, 40), held=(40, 50)),
          _batch(admit=(410, 490), held=(490, 500)),    # profiler on
          _batch(admit=(990, 995), held=(995, 1010)),   # past the window
          _batch(admit=(-5, 1), held=(1, 2))]           # before it
    tr = _trace(450, 600)
    run = _run(bs, tr, profiled=(0.4, 0.7))
    assert read("admit_ms_per_batch.qps", run) == pytest.approx(4.0)
    assert read("harvest_hold_ms.p95", run) == pytest.approx(7.0)
    # The trace's own span (anchor to the close of its read) is left out
    # where the profiler's start and stop are unknown.
    assert read("admit_ms_per_batch.qps", _run(bs, _trace(480, 600))) == \
        pytest.approx(4.0)
    assert read("admit_ms_per_batch.qps", _run(bs, _trace(500, 600))) == \
        pytest.approx((2 + 6 + 80) / 3)


def test_trip_readers():
    bs = [_batch("bandit", trips=10, wait=2_000_000, loop=5_000_000,
                 step=(10, 20)),
          _batch("bandit", trips=30, wait=6_000_000, loop=9_000_000,
                 step=(30, 40)),
          _batch("dense", trips=99, wait=1, loop=1, step=(50, 60)),
          _batch("bandit", trips=50, wait=1, loop=1, step=(500, 520))]
    run = _run(bs, _trace(490, 600))
    # (5 + 9 - 2 - 6) ms over 40 trips; 8 ms over 40 trips.
    assert read("trip_host_us.p95", run) == pytest.approx(150.0)
    assert read("trip_wait_us.p95", run) == pytest.approx(200.0)
    dense_only = _run([bs[2]], _trace(490, 600))
    assert read("trip_host_us.p95", dense_only) is None
    assert read("trip_wait_us.p95", dense_only) is None


def test_gc_pause_share(monkeypatch):
    ev = [(0, 1, OFF + 10 * MS, OFF + 12 * MS),
          (2, 1, OFF + 995 * MS, OFF + 1005 * MS),   # 5 ms in the window
          (1, 2, OFF + 450 * MS, OFF + 460 * MS),    # profiler on
          (0, 1, OFF - 9 * MS, OFF - 8 * MS)]        # before the window
    monkeypatch.setattr(spans, "GC_EVENTS", ev)
    run = _run([], _trace(400, 500), profiled=(0.4, 0.5))
    # 7 ms of pauses over the 900 ms of the window without the profiler.
    assert read("gc_pause_pct.qps", run) == pytest.approx(100 * 7 / 900)
    monkeypatch.setattr(spans, "GC_EVENTS", [])
    assert read("gc_pause_pct.qps", run) == 0.0


def test_readers_return_none_without_the_programs_spans(monkeypatch):
    """A checkout whose records carry no spans (the parent of the spans):
    every reader returns None and none raises."""
    old = types.SimpleNamespace(flavor="bandit", occupancy=1.0,
                                service_s=0.1)
    tr = _trace(100, 200, busy_ms=[(110, 120)])
    monkeypatch.setattr(ps, "gc_events", lambda: None)
    for name in ("idle_in_engine_pct.qps", "admit_ms_per_batch.qps",
                 "gc_pause_pct.qps", "harvest_hold_ms.p95",
                 "trip_host_us.p95", "trip_wait_us.p95"):
        assert read(name, _run([old] * 3, tr, profiled=(0.1, 0.2))) is None


def test_interval_arithmetic():
    assert ps.merged([(5, 9), (0, 2), (1, 3), (9, 9), (8, 12)]) == \
        [(0, 3), (5, 12)]
    assert ps.gaps([(0, 3), (5, 12)], -2, 20) == [(-2, 0), (3, 5), (12, 20)]
    assert ps.gaps([(0, 30)], 5, 20) == []
    assert ps.overlap_ns([(0, 3), (5, 12)], [(2, 6), (11, 40)]) == 3


def test_program_stage1_span_lies_inside_the_harness_span():
    """The harness's recorder around ``_stage1`` and the program's own
    ``stage1`` span: each program span inside a harness span of the same
    thread, with the same query count."""
    from repro_torch.serve import AsyncRetrievalEngine, EngineConfig, Request
    g = torch.Generator().manual_seed(0)
    embs = torch.nn.functional.normalize(torch.randn(64, 12, 16,
                                                     generator=g), dim=-1)
    mask = torch.ones(64, 12, dtype=torch.bool)
    cfg = EngineConfig(batch_size=2, deadline_s=30.0, token_buckets=(8,),
                       cand_buckets=(16,), max_k=5, flavor="dense",
                       stage1_candidates=16, stage1_kprime=4)
    eng = AsyncRetrievalEngine(embs, mask, cfg, device="cpu")
    eng.warmup()
    host = HostSpans()
    host.wrap(eng, "_stage1", "stage1", count_arg=1)
    rng = np.random.default_rng(0)
    with eng:
        for _ in range(6):
            q = rng.standard_normal((8, 16)).astype(np.float32)
            eng.submit(Request(query=q / np.linalg.norm(q, axis=1,
                                                        keepdims=True), k=5))
        eng.drain()
    theirs = [sp for sp in host.spans if sp[0] == "stage1"]
    ours = [b.span("stage1") + (b.counter("stage1_queries"),)
            for b in eng.metrics.batches]
    assert len(ours) == len(theirs) == 3
    for tid, s, e, n in ours:
        assert any(h[1] == tid and h[2] <= s <= e <= h[3] and h[4] == n
                   for h in theirs)
    assert sum(e - s for _, s, e, _ in ours) <= \
        sum(h[3] - h[2] for h in theirs)
