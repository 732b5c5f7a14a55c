"""The port's batch spans, trip counters and engine events
(``repro_torch.spans``) on the CPU.

  * the flat stamps: a span is (thread, start, end), absent until closed;
  * every batch of the synchronous and the threaded engine (dense and
    bandit) records each span, its children inside it, on the thread that
    does that work, with stamps between ``time.time_ns()`` read before and
    after; ``bid`` ties a batch's record to its completions;
  * the pooled trip loop's counters equal ``PooledResult.trips`` of the
    same call, with one host read a trip plus the last test, and no graph
    trip on the eager path; ``graph_trips`` takes one more counter slot;
  * the collector hook, counted by its users, and build events after a
    warmup of chosen buckets.
"""
import gc
import threading
import time

import numpy as np
import pytest
import torch

from repro.data.synthetic import make_retrieval_dataset
from repro_torch import spans
from repro_torch.core.batched import BatchedConfig
from repro_torch.core.frontier import run_pooled_bandit
from repro_torch.serve import (AsyncRetrievalEngine, EngineConfig, Request,
                               RetrievalEngine)
from test_torch_threads import cap_torch_threads

cap_torch_threads()

pytestmark = pytest.mark.timeout(300)

ORDER = ("admit", "queued", "step", "held", "harvest", "deliver")


@pytest.fixture(scope="module")
def corpus():
    return make_retrieval_dataset(n_docs=32, n_queries=8, doc_len=12,
                                  min_doc_len=6, query_len=8, dim=16,
                                  seed=5)


def _cfg(flavor, **kw):
    base = dict(batch_size=2, deadline_s=30.0, token_buckets=(8,),
                cand_buckets=(8,), max_k=5, flavor=flavor,
                stage1_candidates=8, stage1_kprime=4, block_docs=4,
                block_tokens=2)
    base.update(kw)
    return EngineConfig(**base)


def _requests(corpus, n=6):
    """Alternating stage-1 and candidate-carrying requests: each batch of
    two holds one of each."""
    rng = np.random.default_rng(3)
    return [Request(query=corpus.queries[i % 8], k=5,
                    cand_ids=(rng.choice(32, 8, replace=False)
                              .astype(np.int32) if i % 2 else None))
            for i in range(n)]


def _serve(eng, corpus, started):
    t0 = time.time_ns()
    if started:
        eng.start()
    for r in _requests(corpus):
        eng.submit(r)
    done = eng.drain()
    if started:
        eng.stop()
    return t0, time.time_ns(), done


def _check_batches(eng, done, t0, t1, threads):
    """Each record: every span recorded, inside [t0, t1], children inside
    their parent, in pipeline order, each on ``threads[name]``."""
    batches = eng.metrics.batches
    assert len(batches) == 3
    assert sorted(b.bid for b in batches) == [0, 1, 2]
    for b in batches:
        got = {sp.name: sp for sp in b.all_spans()}
        assert set(got) == set(spans.SPANS)
        for sp in got.values():
            assert t0 <= sp.start <= sp.end <= t1, sp
            assert sp.tid == threads[sp.name], sp
            if sp.parent is not None:
                par = got[sp.parent]
                assert par.start <= sp.start <= sp.end <= par.end, sp
        ends = [got[n] for n in ORDER]
        for a, c in zip(ends, ends[1:]):
            assert a.end <= c.start, (a, c)
        assert got["queued"].start == got["admit"].end
        assert got["held"].start == got["step"].end
        assert b.counter("stage1_queries") == 1
        if b.flavor == "bandit":
            trips = b.counter("trips")
            assert trips > 0 and b.counter("reads") == trips + 1
            assert 0 < b.counter("wait_ns") <= b.counter("loop_ns")
            assert b.counter("loop_ns") <= got["step"].end - got["step"].start
        else:
            assert b.counter("trips") == b.counter("reads") == 0
    by_bid = {b.bid: b for b in batches}
    for c in done:
        assert c.bid in by_bid
    assert sorted(c.bid for c in done) == [0, 0, 1, 1, 2, 2]
    return {b.bid: {sp.name: sp for sp in b.all_spans()} for b in batches}


@pytest.mark.parametrize("flavor", ["dense", "bandit"])
def test_sync_engine_records_every_span(corpus, flavor):
    eng = RetrievalEngine(corpus.doc_embs, corpus.doc_mask,
                          _cfg(flavor, max_rounds=3), device="cpu")
    eng.warmup()
    t0, t1, done = _serve(eng, corpus, started=False)
    me = threading.get_native_id()
    got = _check_batches(eng, done, t0, t1,
                         {n: me for n in spans.SPANS})
    for sp in got.values():
        # Nothing waits between the stages of the synchronous path.
        for name in ("queued", "held", "deliver"):
            assert sp[name].start == sp[name].end


@pytest.mark.parametrize("flavor", ["dense", "bandit"])
def test_async_engine_records_every_span_on_its_thread(corpus, flavor):
    eng = AsyncRetrievalEngine(corpus.doc_embs, corpus.doc_mask,
                               _cfg(flavor, max_rounds=3), device="cpu")
    eng.warmup()
    tids = {}
    real_start = eng._spawn

    def spawn(name):
        t = real_start(name)
        tids[name] = t.native_id
        return t

    eng._spawn = spawn
    t0, t1, done = _serve(eng, corpus, started=True)
    admit, dispatch = tids["repro-admit"], tids["repro-dispatch"]
    threads = {n: dispatch for n in spans.SPANS}
    threads.update(admit=admit, stage1=admit, upload=admit)
    _check_batches(eng, done, t0, t1, threads)


def test_continuous_stream_records_its_spans(corpus):
    cfg = _cfg("bandit", continuous=True, stream_trip_limit=2,
               cand_buckets=(8,))
    eng = AsyncRetrievalEngine(corpus.doc_embs, corpus.doc_mask, cfg,
                               device="cpu")
    eng.warmup()
    t0, t1, done = _serve(eng, corpus, started=True)
    assert len(done) == 6
    bids = {b.bid for b in eng.metrics.batches}
    assert len(bids) == len(eng.metrics.batches)
    assert {c.bid for c in done} <= bids
    for b in eng.metrics.batches:
        got = {sp.name: sp for sp in b.all_spans()}
        assert set(got) == set(spans.SPANS) - {"queued", "held"} - (
            set() if b.counter("stage1_queries") else {"stage1"})
        for sp in got.values():
            assert t0 <= sp.start <= sp.end <= t1
            if sp.parent is not None:
                assert got[sp.parent].start <= sp.start
                assert sp.end <= got[sp.parent].end
        trips = b.counter("trips")
        assert 0 < trips <= 2
        assert b.counter("reads") in (trips, trips + 1)


def _pooled_case(seed=11, Q=3, N=16, T=6):
    g = torch.Generator().manual_seed(seed)
    H = torch.rand((Q, N, T), generator=g)
    h = H.reshape(Q * N, T)

    def cells(flat_doc, flat_tok):
        t = flat_tok - (flat_doc // N * T)[:, None]
        return h[flat_doc[:, None], torch.clamp(t, 0, T - 1)]

    a = torch.zeros((Q, N, T))
    b = torch.ones((Q, N, T))
    seeds = torch.arange(Q, dtype=torch.int64) * 7 + 1
    return cells, a, b, seeds


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "chain"])
@pytest.mark.parametrize("trip_limit", [0, 2])
def test_trip_counters_equal_pooled_result(fused, trip_limit):
    cells, a, b, seeds = _pooled_case()
    cfg = BatchedConfig(k=3, block_docs=4, block_tokens=2)
    st = spans.new()
    prev = spans.open_batch(st)
    try:
        res = run_pooled_bandit(cells, a, b, seeds, cfg, fused=fused,
                                trip_limit=trip_limit)
    finally:
        spans.open_batch(prev)
    trips = int(res.trips)
    assert trips > 0 and spans.counter(st, "trips") == trips
    if trip_limit and trips == trip_limit:
        assert spans.counter(st, "reads") == trips
    else:
        assert spans.counter(st, "reads") == trips + 1
    assert 0 < spans.counter(st, "wait_ns") <= spans.counter(st, "loop_ns")
    # No trip graph: no trip replayed one.
    assert spans.counter(st, "graph_trips") == 0
    # Without open stamps the loop records nothing.
    before = spans.new()
    run_pooled_bandit(cells, a, b, seeds, cfg, fused=fused)
    assert spans.open_stamps() is None and before == spans.new()


def test_stamps_layout():
    st = spans.new()
    assert len(st) == spans.WIDTH and spans.spans(st) == []
    assert spans.span(st, "step") is None
    spans.begin(st, spans.STEP)
    assert spans.span(st, "step") is None          # open: not recorded
    spans.end(st, spans.STEP)
    tid, s, e = spans.span(st, "step")
    assert tid == threading.get_native_id() and 0 < s <= e
    spans.instant(st, spans.HELD, e)
    assert spans.span(st, "held")[1:] == (e, e)
    st[spans.TRIPS] += 4
    assert spans.counter(st, "trips") == 4
    assert [sp.name for sp in spans.spans(st)] == ["step", "held"]
    assert spans.spans(st)[0].parent is None


def test_graph_trips_slot():
    """``graph_trips`` is one more counter slot: the stamps grow by one,
    and every span keeps its offset."""
    assert spans.COUNTERS[:5] == ("stage1_queries", "trips", "reads",
                                  "wait_ns", "loop_ns")
    assert set(spans.COUNTERS[5:]) == {"graph_trips", "reveal_rows"}
    assert spans.WIDTH == 3 * 9 + 7 == len(spans.new())
    assert spans.GRAPH_TRIPS == 3 * len(spans.SPANS) + \
        spans.COUNTERS.index("graph_trips")
    st = spans.new()
    st[spans.GRAPH_TRIPS] += 3
    assert spans.counter(st, "graph_trips") == 3
    assert spans.counter(st, "reveal_rows") == spans.counter(st, "trips") \
        == 0


def test_gc_hook_is_counted_by_its_users():
    users = spans._gc_users
    spans.hook_gc()
    spans.hook_gc()
    spans.unhook_gc()
    assert spans._gc_users == users + 1
    assert gc.callbacks.count(spans._on_gc) == 1
    t0 = time.time_ns()
    gc.collect()
    t1 = time.time_ns()
    spans.unhook_gc()
    assert spans._gc_users == users
    assert (spans._on_gc in gc.callbacks) == (users > 0)
    gen, tid, s, e = spans.GC_EVENTS[-1]
    assert gen == 2 and tid == threading.get_native_id()
    assert t0 <= s <= e <= t1


def test_gc_pause_while_an_engine_runs(corpus):
    a = AsyncRetrievalEngine(corpus.doc_embs, corpus.doc_mask, _cfg("dense"),
                             device="cpu")
    b = AsyncRetrievalEngine(corpus.doc_embs, corpus.doc_mask, _cfg("dense"),
                             device="cpu")
    a.warmup()
    b.warmup()
    users = spans._gc_users
    with a:
        with b:
            assert spans._gc_users == users + 2
        assert spans._gc_users == users + 1
        assert spans._on_gc in gc.callbacks
        t0 = time.time_ns()
        gc.collect()
        t1 = time.time_ns()
    assert spans._gc_users == users
    assert (spans._on_gc in gc.callbacks) == (users > 0)
    ev = [e for e in spans.GC_EVENTS if t0 <= e[2] and e[3] <= t1]
    assert ev and ev[-1][0] == 2


def test_warmup_keys_and_build_events(corpus):
    cfg = _cfg("dense", cand_buckets=(8, 16), stage1_candidates=16)
    eng = RetrievalEngine(corpus.doc_embs, corpus.doc_mask, cfg,
                          device="cpu")
    full = RetrievalEngine(corpus.doc_embs, corpus.doc_mask, cfg,
                           device="cpu")
    assert full.warmup() == sorted(full._reachable_keys())
    assert full.metrics.builds == []
    warm = [("step", "dense", 8, 8)]
    assert eng.warmup(keys=warm) == warm
    assert eng.metrics.compiles_after_warmup == 0
    rng = np.random.default_rng(0)
    cand = rng.choice(32, 8, replace=False).astype(np.int32)
    eng.submit(Request(query=corpus.queries[0], k=5, cand_ids=cand))
    eng.submit(Request(query=corpus.queries[1], k=5, cand_ids=cand))
    eng.drain()
    assert eng.metrics.compiles_after_warmup == 0   # a warmed bucket
    t0 = time.time_ns()
    eng.submit(Request(query=corpus.queries[2], k=5, cand_ids=cand))
    eng.submit(Request(query=corpus.queries[3], k=5, cand_ids=None))
    eng.drain()                            # needs stage 1 and (8, 16)
    assert eng.metrics.compiles_after_warmup == 2
    keys = [b[0] for b in eng.metrics.builds]
    assert keys == [("stage1", 8), ("step", "dense", 8, 16)]
    me = threading.get_native_id()
    for _, tid, s, e in eng.metrics.builds:
        assert tid == me and t0 <= s <= e <= time.time_ns()
    # The build happened inside the batch's admit span.
    admit = eng.metrics.batches[-1].span("admit")
    assert all(admit[1] <= s and e <= admit[2]
               for _, _, s, e in eng.metrics.builds)


@pytest.mark.parametrize("stage1", ["host", "local"])
def test_mesh_engine_records_every_span(corpus, stage1):
    """Sharded and routed steps: the same spans; the trip counters sum the
    per-shard loops, each with its own last continue test."""
    cfg = _cfg("bandit", max_rounds=3, mesh_axes=(("data", 2), ("model", 2)),
               stage1=stage1)
    eng = RetrievalEngine(corpus.doc_embs, corpus.doc_mask, cfg,
                          device="cpu")
    eng.warmup()
    reqs = _requests(corpus, 4)
    if stage1 == "local":
        reqs = [r for r in reqs if r.cand_ids is None] * 2
    t0 = time.time_ns()
    for r in reqs:
        eng.submit(r)
    assert len(eng.drain()) == 4
    t1 = time.time_ns()
    for b in eng.metrics.batches:
        got = {sp.name: sp for sp in b.all_spans()}
        want = set(spans.SPANS) - ({"stage1"} if stage1 == "local" else set())
        assert set(got) == want
        assert all(t0 <= sp.start <= sp.end <= t1 for sp in got.values())
        loops = b.counter("reads") - b.counter("trips")
        assert b.counter("trips") > 0 and 1 <= loops <= 4
