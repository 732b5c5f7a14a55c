"""The port's synchronous ``RetrievalEngine`` on the CPU: the JAX engine's
contracts (validation, deadline-miss accounting, the caller's Request left
alone, per-batch draws, admission headroom, build-once and zero rebuilds
after warmup) and parity with the JAX ``RetrievalEngine`` on the same
requests.

Parity: the JAX engine runs its plain lane (``REPRO_KERNEL_IMPL=ref``) and
the port replays its keys (``JaxReplayDraws``: a batch's keys are
``split(fold_in(key(seed), ordinal), B)``). Completions' ids, flavors,
buckets, reveal fractions and ladder levels must match exactly, and each
batch's rounds, lockstep waste and quarantined cells too; scores match to
rtol=1e-5 because the two frameworks sum a doc's cells in different
orders.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.data.synthetic import make_retrieval_dataset
from repro.dist.fault import ChaosClock as JChaosClock
from repro.dist.fault import poison_corpus as j_poison_corpus
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import RetrievalEngine as JRetrievalEngine
from repro_torch.dist.fault import ChaosClock
from repro_torch.kernels.maxsim import maxsim_plain
from repro_torch.serve import EngineConfig, Request, RetrievalEngine
from test_torch_core import JaxReplayDraws

RTOL, ATOL = 1e-5, 1e-6
REPLAY = JaxReplayDraws()


class ManualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module")
def corpus():
    return make_retrieval_dataset(n_docs=48, n_queries=16, doc_len=16,
                                  min_doc_len=6, query_len=16, dim=16,
                                  seed=3)


@pytest.fixture
def ref_lane(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "ref")


def _dense_cfg(**kw):
    base = dict(batch_size=4, deadline_s=0.5, token_buckets=(8, 16),
                cand_buckets=(16,), max_k=5, flavor="dense",
                stage1_candidates=16, stage1_kprime=4)
    base.update(kw)
    return EngineConfig(**base)


def _engine(corpus, cfg, **kw):
    return RetrievalEngine(corpus.doc_embs, corpus.doc_mask, cfg,
                           device="cpu", **kw)


# ---------------------------------------------------------------------------
# contracts of the JAX engine's tests, on the port
# ---------------------------------------------------------------------------

def test_submit_validation(corpus):
    eng = _engine(corpus, _dense_cfg())
    with pytest.raises(ValueError):              # too many query tokens
        eng.submit(Request(query=np.zeros((17, 16), np.float32)))
    with pytest.raises(ValueError):              # k beyond max_k
        eng.submit(Request(query=np.zeros((4, 16), np.float32), k=9))
    with pytest.raises(ValueError):              # wrong embedding dim
        eng.submit(Request(query=np.zeros((4, 8), np.float32)))
    with pytest.raises(ValueError):              # candidate id off the corpus
        eng.submit(Request(query=np.zeros((4, 16), np.float32),
                           cand_ids=np.array([0, 99], np.int32)))
    with pytest.raises(ValueError):              # too many candidates
        eng.submit(Request(query=np.zeros((4, 16), np.float32),
                           cand_ids=np.arange(17)))
    q8 = _engine(corpus, _dense_cfg(corpus_format="int8"))
    with pytest.raises(ValueError, match="candidate-less"):
        q8.submit(Request(query=np.zeros((4, 16), np.float32)))
    with pytest.raises(ValueError, match="unknown flavor"):
        _engine(corpus, _dense_cfg(flavor="sparse")).warmup()


def test_deadline_miss_accounting(corpus):
    clock = ManualClock()
    eng = _engine(corpus, _dense_cfg(deadline_s=1.0), clock=clock)
    eng.warmup()
    q = corpus.queries[0][:8]
    eng.submit(Request(query=q, k=5, deadline_s=0.05))
    eng.submit(Request(query=q, k=5, deadline_s=0.05))
    assert eng.poll() == []                      # not full, not expired yet
    clock.advance(0.2)
    done = eng.poll()
    assert len(done) == 2
    assert all(c.deadline_miss for c in done)
    assert all(abs(c.queue_wait_s - 0.2) < 1e-9 for c in done)

    eng.submit(Request(query=q, k=5, deadline_s=0.3))
    assert eng.next_expiry() == pytest.approx(clock.t + 0.3)
    clock.advance(0.3)
    done = eng.poll()
    assert len(done) == 1 and not done[0].deadline_miss

    for _ in range(4):
        eng.submit(Request(query=q, k=5, deadline_s=0.05))
    done = eng.poll()
    assert len(done) == 4
    assert not any(c.deadline_miss for c in done)
    assert all(c.queue_wait_s == 0.0 for c in done)

    s = eng.metrics.summary()
    assert s["n_requests"] == 7
    assert s["deadline_miss_rate"] == pytest.approx(2 / 7)


def test_submit_does_not_mutate_caller_request(corpus):
    clock = ManualClock()
    eng = _engine(corpus, _dense_cfg(batch_size=2), clock=clock)
    req = Request(query=corpus.queries[0][:8], k=5,
                  cand_ids=np.arange(8, dtype=np.int32))
    r0 = eng.submit(req)
    clock.advance(0.1)
    r1 = eng.submit(req)
    assert req.rid == -1 and req.arrival == 0.0      # caller copy untouched
    done = {c.rid: c for c in eng.poll()}
    assert set(done) == {r0, r1} and r0 != r1
    assert done[r0].queue_wait_s == pytest.approx(0.1)
    assert done[r1].queue_wait_s == pytest.approx(0.0)


def test_miss_counted_for_admission_after_stale_next_expiry(corpus):
    clock = ManualClock()
    eng = _engine(corpus, _dense_cfg(deadline_s=1.0), clock=clock)
    eng.warmup()
    q = corpus.queries[0][:8]
    eng.submit(Request(query=q, k=5))              # no deadline
    assert eng.next_expiry() == pytest.approx(1.0)
    clock.advance(0.5)
    rid_late = eng.submit(Request(query=q, k=5, deadline_s=0.05))
    clock.advance(0.5)
    done = {c.rid: c for c in eng.poll()}
    assert done[rid_late].deadline_miss
    assert sum(c.deadline_miss for c in done.values()) == 1
    assert eng.metrics.summary()["deadline_miss_rate"] == pytest.approx(0.5)


@pytest.mark.parametrize("draws", [None, REPLAY], ids=["torch", "replay"])
def test_per_batch_prng_folds_ordinal_and_replays_deterministically(
        corpus, draws):
    """Two batches of the SAME request reveal distinct trajectories (the
    batch ordinal is folded into the seed), and replaying the stream on a
    fresh engine reproduces every score bit for bit."""
    def serve_stream():
        cfg = _dense_cfg(batch_size=1, flavor="bandit", alpha_ef=0.3,
                         max_rounds=2, block_docs=4, block_tokens=2,
                         token_buckets=(8,))
        eng = _engine(corpus, cfg, draws=draws)
        out = []
        for _ in range(2):                         # ordinals 0, 1
            eng.submit(Request(query=corpus.queries[0][:8], k=5,
                               cand_ids=np.arange(16, dtype=np.int32)))
            out += eng.poll()
        return out

    first = serve_stream()
    assert not np.allclose(first[0].topk_scores, first[1].topk_scores)
    replay = serve_stream()
    for c0, c1 in zip(first, replay):
        np.testing.assert_array_equal(c0.topk_scores, c1.topk_scores)
        np.testing.assert_array_equal(c0.topk_ids, c1.topk_ids)
        assert c0.reveal_fraction == c1.reveal_fraction


def test_admission_leaves_service_headroom(corpus):
    clock = ManualClock()
    eng = _engine(corpus, _dense_cfg(deadline_headroom_s=0.02), clock=clock)
    eng.submit(Request(query=corpus.queries[0][:8], k=5, deadline_s=0.05))
    assert eng.next_expiry() == pytest.approx(0.03)


def test_cold_engine_compiles_each_bucket_exactly_once(corpus):
    """Without warmup the first batch per bucket builds (and runs once) its
    step; every later hit of the bucket reuses it."""
    eng = _engine(corpus, _dense_cfg())
    q_small, q_large = corpus.queries[0][:6], corpus.queries[1][:12]
    for _ in range(3):
        for q in (q_small,) * 4:
            eng.submit(Request(query=q, k=5))
        eng.poll()
        for q in (q_large,) * 4:
            eng.submit(Request(query=q, k=5))
        eng.poll()
    assert len(eng.metrics.completions) == 24
    assert all(count == 1 for count in eng.metrics.compiles.values())
    assert {c.bucket for c in eng.metrics.completions} == {(8, 16), (16, 16)}


def test_warm_engine_serves_64_request_mixed_stream_with_zero_recompiles(
        corpus):
    clock = ManualClock()
    eng = _engine(corpus, _dense_cfg(deadline_s=0.01), clock=clock)
    assert eng.warmup() == sorted([("stage1", 8), ("stage1", 16),
                                   ("step", "dense", 8, 16),
                                   ("step", "dense", 16, 16)])
    compiled = dict(eng.metrics.compiles)
    assert compiled and all(n == 1 for n in compiled.values())

    rng = np.random.default_rng(0)
    done = []
    for i in range(64):
        n_tok = int(rng.integers(2, 17))
        cand = (rng.choice(48, int(rng.integers(4, 17)), replace=False)
                if i % 2 else None)
        eng.submit(Request(query=corpus.queries[i % 16][:n_tok], k=5,
                           deadline_s=0.05, cand_ids=cand))
        clock.advance(float(rng.uniform(0, 0.01)))
        done += eng.poll()
    done += eng.drain()

    assert len(done) == 64
    assert eng.metrics.compiles_after_warmup == 0
    assert dict(eng.metrics.compiles) == compiled
    assert {c.bucket[0] for c in done} == {8, 16}
    s = eng.metrics.summary()
    assert s["n_requests"] == 64 and s["compiles_after_warmup"] == 0


def test_dense_results_match_reference(corpus):
    eng = _engine(corpus, _dense_cfg())
    cand = np.arange(16, dtype=np.int32)
    q = corpus.queries[2][:8]
    eng.submit(Request(query=q, k=5, cand_ids=cand))
    done = eng.drain()
    assert len(done) == 1
    h = maxsim_plain(torch.as_tensor(corpus.doc_embs[cand]),
                     torch.as_tensor(corpus.doc_mask[cand]),
                     torch.as_tensor(np.asarray(q, np.float32)))
    s_ref = h.sum(-1).numpy()
    assert int(done[0].topk_ids[0]) == int(cand[np.argmax(s_ref)])
    np.testing.assert_allclose(done[0].topk_scores[0], s_ref.max(),
                               atol=1e-4)
    assert done[0].reveal_fraction == pytest.approx(1.0)


def test_engine_serves_bf16_corpus_matching_f32_topk(corpus):
    cfg = _dense_cfg(batch_size=2, token_buckets=(8,), flavor="bandit",
                     block_docs=4, block_tokens=4, max_rounds=8)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        eng = RetrievalEngine(torch.as_tensor(corpus.doc_embs).to(dtype),
                              corpus.doc_mask, cfg, device="cpu")
        assert eng.corpus_embs.dtype == dtype
        eng.warmup()
        for i in range(2):
            eng.submit(Request(query=corpus.queries[i, :8], k=5,
                               cand_ids=np.arange(16)))
        results[dtype] = sorted(eng.drain(), key=lambda c: c.rid)
        assert eng.metrics.compiles_after_warmup == 0
    for c32, c16 in zip(results[torch.float32], results[torch.bfloat16]):
        assert set(c32.topk_ids) == set(c16.topk_ids)


@pytest.mark.parametrize("setting", [
    dict(mesh_axes=(("data", 2),)),
    dict(mesh_axes=(("data", 2),), stage1="local"),
    dict(autotune=True),
    dict(tuning_table="table.json"),
    dict(audit=True),
], ids=["mesh", "routed", "autotune", "tuning_table", "audit"])
def test_settings_not_ported_raise(corpus, setting):
    with pytest.raises(NotImplementedError, match="Queue 1 item"):
        _engine(corpus, _dense_cfg(**setting))


def test_off_mesh_settings_raise_as_in_jax(corpus):
    for cfg in (dict(stage1="local"), dict(stage1="edge"),
                dict(corpus_format="fp4"),
                dict(corpus_format="int8", stage1="local")):
        with pytest.raises(ValueError) as ours:
            _engine(corpus, _dense_cfg(**cfg))
        with pytest.raises(ValueError) as theirs:
            JRetrievalEngine(corpus.doc_embs, corpus.doc_mask,
                             JEngineConfig(**dataclasses.asdict(
                                 _dense_cfg(**cfg))))
        assert str(ours.value) == str(theirs.value)
    eng = _engine(corpus, _dense_cfg())
    with pytest.raises(ValueError, match="needs a mesh-resident corpus"):
        eng.set_shard_health(0, False)
    with pytest.raises(ValueError, match="needs a mesh-resident corpus"):
        eng.restore_shard(0)
    with pytest.raises(ValueError, match="ladder fields"):
        _engine(corpus, _dense_cfg(degrade_round_caps=(0,)))


# ---------------------------------------------------------------------------
# parity with the JAX engine
# ---------------------------------------------------------------------------

def _jax_cfg(cfg: EngineConfig) -> JEngineConfig:
    return JEngineConfig(**dataclasses.asdict(cfg))


def _serve_both(embs, mask, cfg, requests, *, j_clock=None, t_clock=None):
    """Serve the same (query, cand_ids, deadline_s) stream through the JAX
    engine and the port's; (JAX engine, its completions, port engine,
    its completions), completions by rid."""
    j = JRetrievalEngine(embs, mask, _jax_cfg(cfg),
                         **({"clock": j_clock} if j_clock else {}))
    t = RetrievalEngine(embs, mask, cfg, device="cpu", draws=REPLAY,
                        **({"clock": t_clock} if t_clock else {}))
    out = []
    for eng, req in ((j, JRequest), (t, Request)):
        eng.warmup()
        for q, cand, deadline in requests:
            eng.submit(req(query=q, k=cfg.max_k, cand_ids=cand,
                           deadline_s=deadline))
        out += [eng, {c.rid: c for c in eng.drain()}]
        assert eng.metrics.compiles_after_warmup == 0
    return out


def _assert_parity(j_eng, want, t_eng, got):
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        np.testing.assert_array_equal(g.topk_ids, w.topk_ids)
        np.testing.assert_allclose(g.topk_scores, w.topk_scores, rtol=RTOL,
                                   atol=ATOL)
        assert (g.flavor, g.bucket, g.reveal_fraction, g.degrade_level,
                g.coverage, g.error) == (w.flavor, w.bucket,
                                         w.reveal_fraction, w.degrade_level,
                                         w.coverage, w.error)
    assert len(t_eng.metrics.batches) == len(j_eng.metrics.batches)
    for g, w in zip(t_eng.metrics.batches, j_eng.metrics.batches):
        assert (g.bucket, g.flavor, g.n_real, g.total_rounds,
                g.lockstep_waste, g.quarantined, g.degrade_level) == (
            w.bucket, w.flavor, w.n_real, w.total_rounds, w.lockstep_waste,
            w.quarantined, w.degrade_level)
        np.testing.assert_allclose(g.reveal_fraction, w.reveal_fraction,
                                   rtol=RTOL)
        np.testing.assert_allclose(g.frontier_occupancy,
                                   w.frontier_occupancy, rtol=RTOL)
    j_keys = set(j_eng.metrics.summary())
    assert set(t_eng.metrics.summary()) == j_keys


@functools.lru_cache(maxsize=None)
def _mixed_requests(seed=0):
    """Four batches of 4 at variable token counts: stage-1 requests (32
    candidates: bandit), 16 candidates (dense bucket), 32 candidates
    (bandit bucket), then the three kinds mixed."""
    ds = make_retrieval_dataset(n_docs=48, n_queries=16, doc_len=16,
                                min_doc_len=6, query_len=16, dim=16, seed=3)
    rng = np.random.default_rng(seed)
    reqs = []
    for i, kind in enumerate([0] * 4 + [1] * 4 + [2] * 4 + [0, 1, 2, 1]):
        n_tok = int(rng.integers(2, 17))
        cand = (None if kind == 0 else rng.choice(
            48, 16 if kind == 1 else 32, replace=False).astype(np.int32))
        reqs.append((ds.queries[i % 16][:n_tok], cand, None))
    return ds, reqs


_MIXED = dict(batch_size=4, deadline_s=30.0, token_buckets=(8, 16),
              cand_buckets=(16, 32), max_k=5, flavor="auto",
              bandit_min_candidates=32, stage1_candidates=32,
              stage1_kprime=4, block_docs=4, block_tokens=2)


@pytest.mark.parametrize("case", ["mixed", "dense", "bandit", "int8",
                                  "residual", "vmapped"])
def test_engine_matches_jax(ref_lane, case):
    """Dense, bandit (fused by default; JAX's plain lane runs the chain
    body, which gives the same cells), stage-1 and quantized batches, and
    the lockstep engine: the same stream through both engines."""
    ds, reqs = _mixed_requests()
    cfg = dict(_MIXED)
    if case == "dense":
        cfg.update(flavor="dense")
    elif case == "bandit":
        cfg.update(flavor="bandit", token_buckets=(16,))
    elif case in ("int8", "residual"):
        cfg.update(corpus_format=case, token_buckets=(16,))
        reqs = [r for r in reqs if r[1] is not None]
    elif case == "vmapped":
        cfg.update(flavor="bandit", bandit_engine="vmapped",
                   token_buckets=(16,), cand_buckets=(32,), max_rounds=6)
        reqs = [r for r in reqs if r[1] is None or len(r[1]) == 32]
    j_eng, want, t_eng, got = _serve_both(ds.doc_embs, ds.doc_mask,
                                          EngineConfig(**cfg), reqs)
    _assert_parity(j_eng, want, t_eng, got)
    flavors = {c.flavor for c in got.values()}
    assert flavors == ({"dense"} if case == "dense" else
                       {"bandit"} if case in ("bandit", "vmapped") else
                       {"dense", "bandit"})


def test_engine_ladder_levels_match_jax(ref_lane):
    """backpressure="degrade" under a frozen ChaosClock: each pair of
    requests' deadline puts its batch on one rung (headroom ratio 2, 0.7,
    0.4, 0.1 against a 1 s service floor -> levels 0, 1, 2, 3); levels,
    results and rounds match the JAX engine, and nothing rebuilds."""
    rng = np.random.default_rng(0)
    C, L, M, T = 48, 6, 16, 8
    embs = rng.standard_normal((C, L, M)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=-1, keepdims=True)
    mask = np.arange(L)[None] < rng.integers(3, L + 1, C)[:, None]
    q = rng.standard_normal((T, M)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    reqs = [(q, rng.choice(C, 16, replace=False).astype(np.int32), d)
            for d in (2.0, 2.0, 0.7, 0.7, 0.4, 0.4, 0.1, 0.1)]
    cfg = EngineConfig(batch_size=2, token_buckets=(8,), cand_buckets=(16,),
                       max_k=5, flavor="bandit", alpha_ef=0.3, block_docs=4,
                       block_tokens=2, backpressure="degrade",
                       deadline_headroom_s=1.0)
    j_eng, want, t_eng, got = _serve_both(embs, mask, cfg, reqs,
                                          j_clock=JChaosClock(),
                                          t_clock=ChaosClock())
    _assert_parity(j_eng, want, t_eng, got)
    assert [got[r].degrade_level for r in sorted(got)] == [0, 0, 1, 1, 2, 2,
                                                          3, 3]
    assert t_eng.metrics.summary()["ladder_degraded_batches"] == 3


def test_engine_ladder_level0_is_bit_identical():
    rng = np.random.default_rng(1)
    C, L, M, T = 48, 6, 16, 8
    embs = rng.standard_normal((C, L, M)).astype(np.float32)
    mask = np.ones((C, L), bool)
    q = rng.standard_normal((T, M)).astype(np.float32)
    cfg = EngineConfig(batch_size=2, token_buckets=(8,), cand_buckets=(16,),
                       max_k=5, flavor="bandit", alpha_ef=0.3, block_docs=4,
                       block_tokens=2)
    cands = [rng.choice(C, 16, replace=False).astype(np.int32)
             for _ in range(4)]
    outs = []
    for deadline in (None, 1e6):
        bp = "none" if deadline is None else "degrade"
        eng = RetrievalEngine(embs, mask, dataclasses.replace(
            cfg, backpressure=bp), device="cpu")
        for c in cands:
            eng.submit(Request(query=q, k=5, deadline_s=deadline,
                               cand_ids=c))
        outs.append({c.rid: c for c in eng.drain()})
    for rid, c in outs[0].items():
        np.testing.assert_array_equal(c.topk_ids, outs[1][rid].topk_ids)
        np.testing.assert_array_equal(c.topk_scores,
                                      outs[1][rid].topk_scores)
        assert c.coverage == 1.0 and c.degrade_level == 0


@pytest.mark.parametrize("flavor", ["dense", "bandit"])
def test_engine_quarantines_poisoned_rows_as_jax(ref_lane, flavor):
    """A NaN-poisoned row forced into every candidate list is quarantined
    by the steps' finite-score guard, never served; the quarantine counts
    (the steps' stats[3]) equal the JAX engine's."""
    rng = np.random.default_rng(2)
    C, L, M, T = 32, 6, 16, 8
    embs = rng.standard_normal((C, L, M)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=-1, keepdims=True)
    mask = np.arange(L)[None] < rng.integers(3, L + 1, C)[:, None]
    q = rng.standard_normal((T, M)).astype(np.float32)
    poisoned, rows = j_poison_corpus(embs, 1.0 / 32, seed=5)
    bad = int(np.flatnonzero(rows)[0])
    reqs = []
    for _ in range(4):
        cand = rng.choice(C, 16, replace=False).astype(np.int32)
        cand[0] = bad
        reqs.append((q, cand, None))
    cfg = EngineConfig(batch_size=2, token_buckets=(8,), cand_buckets=(16,),
                       max_k=5, flavor=flavor, alpha_ef=0.3, block_docs=4,
                       block_tokens=2)
    j_eng, want, t_eng, got = _serve_both(poisoned, mask, cfg, reqs)
    _assert_parity(j_eng, want, t_eng, got)
    for c in got.values():
        assert bad not in c.topk_ids.tolist()
        assert np.isfinite(c.topk_scores).all()
    assert t_eng.metrics.summary()["quarantined_total"] >= 4

