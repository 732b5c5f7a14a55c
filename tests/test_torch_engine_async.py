"""The port's ``AsyncRetrievalEngine`` on the CPU: the JAX async engine's
contracts and parity with it.

  * parity oracle: an un-``start()``-ed async engine serves exactly like
    the sync engine, and a started one (full batches, no deadlines)
    returns bit-identical completions;
  * completion integrity: every admitted rid surfaces exactly once, in the
    batch pipeline and in the continuous (slot-refill) stream;
  * admission backpressure: "reject" raises ``AdmissionRejected`` (and
    counts it), "degrade" truncates the candidate list to the smallest
    bucket (and counts it), neither mutates the caller's Request;
  * zero rebuilds after warmup, and restartability;
  * continuous mode against the JAX engine's continuous mode: a request's
    result depends on its slot seed ``fold_in(key(seed), rid)`` alone
    (fixed blocks, ``max_block_docs=0``), so each rid matches exactly
    (ids, reveal fraction) whatever its slotmates and admission timing,
    on an f32 and an int8 corpus; scores to rtol=1e-5.

Threaded tests carry ``pytest.mark.timeout`` so a wedged serving thread
fails the run instead of hanging it.
"""
import dataclasses

import numpy as np
import pytest

from repro.data.synthetic import make_retrieval_dataset
from repro.serve import AsyncRetrievalEngine as JAsyncRetrievalEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import RetrievalEngine as JRetrievalEngine
from repro_torch.serve import (AdmissionRejected, AsyncRetrievalEngine,
                               EngineConfig, Request, RetrievalEngine)
from test_torch_core import JaxReplayDraws
from test_torch_threads import cap_torch_threads

cap_torch_threads()

pytestmark = pytest.mark.timeout(300)
RTOL, ATOL = 1e-5, 1e-6
REPLAY = JaxReplayDraws()


@pytest.fixture(scope="module")
def corpus():
    return make_retrieval_dataset(n_docs=32, n_queries=8, doc_len=12,
                                  min_doc_len=6, query_len=8, dim=16,
                                  seed=5)


@pytest.fixture
def ref_lane(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "ref")


def _cfg(**kw):
    # deadline_s is the ADMISSION window: 30 s means only full batches
    # release during a test, so sync and async batch composition match.
    base = dict(batch_size=2, deadline_s=30.0, token_buckets=(8,),
                cand_buckets=(8,), max_k=5, flavor="dense",
                stage1_candidates=8, stage1_kprime=4, pipeline_depth=2)
    base.update(kw)
    return EngineConfig(**base)


def _bandit_cfg(**kw):
    base = dict(flavor="bandit", max_rounds=2, block_docs=4, block_tokens=2)
    base.update(kw)
    return _cfg(**base)


def _make(cls, corpus, cfg, **kw):
    eng = cls(corpus.doc_embs, corpus.doc_mask, cfg, device="cpu", **kw)
    eng.warmup()
    return eng


def _stream(corpus, rng, n, *, deadline_s=None, req=Request):
    """A mixed request stream: variable token counts, alternating
    candidate-carrying / stage-1 requests."""
    reqs = []
    for i in range(n):
        n_tok = int(rng.integers(2, 9))
        cand = (rng.choice(32, 8, replace=False).astype(np.int32)
                if i % 2 else None)
        reqs.append(req(query=corpus.queries[i % 8][:n_tok], k=5,
                        deadline_s=deadline_s, cand_ids=cand))
    return reqs


def _by_rid(comps):
    out = {c.rid: c for c in comps}
    assert len(out) == len(comps)        # no duplicated rid
    return out


def _assert_bitwise_equal(got, want):
    assert set(got) == set(want)
    for rid, c in got.items():
        np.testing.assert_array_equal(c.topk_ids, want[rid].topk_ids)
        np.testing.assert_array_equal(c.topk_scores, want[rid].topk_scores)
        assert c.reveal_fraction == want[rid].reveal_fraction


def _assert_matches_jax(got, want):
    assert set(got) == set(want)
    for rid, w in want.items():
        g = got[rid]
        np.testing.assert_array_equal(g.topk_ids, w.topk_ids)
        np.testing.assert_allclose(g.topk_scores, w.topk_scores, rtol=RTOL,
                                   atol=ATOL)
        assert (g.flavor, g.bucket, g.reveal_fraction, g.coverage) == (
            w.flavor, w.bucket, w.reveal_fraction, w.coverage)


# ---------------------------------------------------------------------------
# parity: un-started == sync; started batch pipeline == sync, bit for bit
# ---------------------------------------------------------------------------

def test_unstarted_async_engine_is_sync_parity(corpus):
    rng = np.random.default_rng(0)
    reqs = _stream(corpus, rng, 6)
    results = []
    for cls in (RetrievalEngine, AsyncRetrievalEngine):
        eng = _make(cls, corpus, _bandit_cfg())
        for r in reqs:
            eng.submit(r)
        results.append(_by_rid(eng.drain()))
        assert eng.metrics.compiles_after_warmup == 0
    _assert_bitwise_equal(results[1], results[0])


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_async_pipeline_matches_sync_bitwise(corpus, depth):
    """Started batch pipeline, full batches only: completions bit-identical
    to the sync engine's for the same stream, whatever the pipeline depth
    (the per-batch ordinal contract survives the thread split)."""
    reqs = _stream(corpus, np.random.default_rng(1), 8)
    sync = _make(RetrievalEngine, corpus, _bandit_cfg())
    for r in reqs:
        sync.submit(r)
    want = _by_rid(sync.drain())
    eng = _make(AsyncRetrievalEngine, corpus,
                _bandit_cfg(pipeline_depth=depth))
    with eng:
        for r in reqs:
            eng.submit(r)
        got = _by_rid(eng.drain())
    assert eng.metrics.compiles_after_warmup == 0
    _assert_bitwise_equal(got, want)


@pytest.mark.parametrize("seed", range(5))
def test_async_drain_equivalence_property(corpus, seed):
    """For a random dense stream, drain() through the started pipeline
    returns the same completions (rids, scores) as the sync engine."""
    rng = np.random.default_rng(seed)
    reqs = _stream(corpus, rng, int(rng.integers(1, 10)))
    sync = _make(RetrievalEngine, corpus, _cfg())
    eng = _make(AsyncRetrievalEngine, corpus, _cfg())
    for r in reqs:
        sync.submit(r)
    want = _by_rid(sync.drain())
    with eng:
        for r in reqs:
            eng.submit(r)
        got = _by_rid(eng.drain())
    _assert_bitwise_equal(got, want)


def test_async_batch_mode_matches_jax(ref_lane, corpus):
    """The started port pipeline against the JAX sync engine on replayed
    keys: stage-1 and candidate-carrying bandit batches."""
    reqs = _stream(corpus, np.random.default_rng(4), 8)
    j = JRetrievalEngine(corpus.doc_embs, corpus.doc_mask,
                         JEngineConfig(**dataclasses.asdict(_bandit_cfg())))
    j.warmup()
    for r in _stream(corpus, np.random.default_rng(4), 8, req=JRequest):
        j.submit(r)
    want = _by_rid(j.drain())
    eng = _make(AsyncRetrievalEngine, corpus, _bandit_cfg(), draws=REPLAY)
    with eng:
        for r in reqs:
            eng.submit(r)
        got = _by_rid(eng.drain())
    _assert_matches_jax(got, want)


# ---------------------------------------------------------------------------
# admission backpressure
# ---------------------------------------------------------------------------

def test_backpressure_reject_counts_and_raises(corpus):
    eng = AsyncRetrievalEngine(
        corpus.doc_embs, corpus.doc_mask,
        _cfg(backpressure="reject", deadline_headroom_s=0.2), device="cpu")
    with pytest.raises(AdmissionRejected):
        eng.submit(Request(query=corpus.queries[0][:4], k=5,
                           deadline_s=0.05))
    assert eng.metrics.summary()["rejected"] == 1
    eng.submit(Request(query=corpus.queries[0][:4], k=5, deadline_s=10.0))
    assert len(eng.drain()) == 1


def test_backpressure_degrade_truncates_candidates(corpus):
    eng = AsyncRetrievalEngine(
        corpus.doc_embs, corpus.doc_mask,
        _cfg(cand_buckets=(4, 8), max_k=4, backpressure="degrade",
             deadline_headroom_s=0.2, batch_size=1), device="cpu")
    req = Request(query=corpus.queries[0][:4], k=4, deadline_s=0.05,
                  cand_ids=np.arange(8, dtype=np.int32))
    rid = eng.submit(req)
    assert len(req.cand_ids) == 8                 # caller copy untouched
    done = _by_rid(eng.drain())
    assert done[rid].bucket == (8, 4)             # served the cheap bucket
    assert done[rid].coverage == pytest.approx(0.5)
    assert eng.metrics.summary()["degraded"] == 1
    rid2 = eng.submit(Request(query=corpus.queries[1][:4], k=4,
                              deadline_s=0.05))
    done = _by_rid(eng.drain())
    assert done[rid2].bucket == (8, 8)            # stage 1: plain admission
    assert eng.metrics.summary()["degraded"] == 1
    with pytest.raises(ValueError, match="backpressure"):
        AsyncRetrievalEngine(corpus.doc_embs, corpus.doc_mask,
                             _cfg(backpressure="shed"), device="cpu")
    with pytest.raises(ValueError, match="pipeline_depth"):
        AsyncRetrievalEngine(corpus.doc_embs, corpus.doc_mask,
                             _cfg(pipeline_depth=0), device="cpu")


# ---------------------------------------------------------------------------
# continuous (slot-refill) runtime
# ---------------------------------------------------------------------------

def test_continuous_submit_requires_start(corpus):
    eng = AsyncRetrievalEngine(corpus.doc_embs, corpus.doc_mask,
                               _bandit_cfg(continuous=True,
                                           stream_trip_limit=2),
                               device="cpu")
    with pytest.raises(RuntimeError, match="start"):
        eng.submit(Request(query=corpus.queries[0][:4], k=5))


def test_continuous_integrity_determinism_and_futures(corpus):
    """Every submitted rid completes exactly once (more requests than
    slots, so refill runs), futures resolve, a replay reproduces every
    score bit for bit (slot seeds are fold_in(rid), not the slot index),
    and the warmed stream step never rebuilds."""
    def serve_once():
        eng = _make(AsyncRetrievalEngine, corpus,
                    _bandit_cfg(continuous=True, stream_trip_limit=2,
                                max_rounds=4))
        rng = np.random.default_rng(2)
        with eng:
            rids = [eng.submit(r) for r in _stream(corpus, rng, 7)]
            futs = [eng.future(rid) for rid in rids]
            done = _by_rid(eng.drain())
        assert eng.metrics.compiles_after_warmup == 0
        assert sorted(done) == sorted(rids)
        assert all(f.result(timeout=1).rid == rid
                   for f, rid in zip(futs, rids))
        assert eng.metrics.summary()["mean_occupancy"] > 0
        assert eng.future(10 ** 6) is None
        return done

    _assert_bitwise_equal(serve_once(), serve_once())


@pytest.mark.parametrize("fmt", ["bf16", "int8"], ids=["f32", "int8"])
def test_continuous_matches_jax_per_rid(ref_lane, corpus, fmt):
    """Each rid of the port's stream equals the JAX engine's continuous
    mode on the same rid and seed, whatever the two runs' slot timing."""
    cfg = _bandit_cfg(continuous=True, stream_trip_limit=2, max_rounds=4,
                      corpus_format=fmt, cand_buckets=(8, 16))
    n = 9
    outs = []
    for cls, req, kw in ((JAsyncRetrievalEngine, JRequest, {}),
                         (AsyncRetrievalEngine, Request,
                          dict(device="cpu", draws=REPLAY))):
        conf = (JEngineConfig(**dataclasses.asdict(cfg))
                if cls is JAsyncRetrievalEngine else cfg)
        eng = cls(corpus.doc_embs, corpus.doc_mask, conf, **kw)
        eng.warmup()
        reqs = _stream(corpus, np.random.default_rng(6), n, req=req)
        if fmt != "bf16":            # quantized: candidate-carrying only
            reqs = [dataclasses.replace(r, cand_ids=np.arange(
                        4 * i % 24, 4 * i % 24 + 8, dtype=np.int32))
                    if r.cand_ids is None else r
                    for i, r in enumerate(reqs)]
        with eng:
            for r in reqs:
                eng.submit(r)
            outs.append(_by_rid(eng.drain()))
        assert sorted(outs[-1]) == list(range(n))
        assert eng.metrics.compiles_after_warmup == 0
    _assert_matches_jax(outs[1], outs[0])


def test_async_engine_restartable(corpus):
    eng = _make(AsyncRetrievalEngine, corpus, _cfg())
    rng = np.random.default_rng(3)
    for _ in range(2):
        with eng:
            for r in _stream(corpus, rng, 4):
                eng.submit(r)
            assert len(eng.drain()) == 4
    assert eng.metrics.summary()["n_requests"] == 8
    assert eng.metrics.compiles_after_warmup == 0
