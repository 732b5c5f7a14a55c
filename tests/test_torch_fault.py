"""The port's fault-tolerance layer on the CPU: the deadline batcher and the
chaos harness (``repro_torch.dist.fault``) against the JAX package's, the
``Supervisor`` watchdog, the supervised engine's zero-lost / zero-duplicated
delivery, ``stop()``'s flush, a single-device chaos soak, and the
thread-safety of kernel loading and launch counting (``kernels._build``).

Pure-Python pieces (batcher, fault plans, ``poison_corpus``) must behave
exactly as the JAX package's on the same inputs. The engine tests run the
port alone at a tiny size; ``test_torch_engine*.py`` hold it to the JAX
engine.
"""
import ctypes
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest

from repro.analysis import locks
from repro.analysis.recorder import ThreadAccessRecorder
from repro.dist import fault as jfault
from repro_torch.dist.fault import (ChaosClock, ChaosKill, DeadlineBatcher,
                                    FaultPlan, InjectedFault, apply_delay,
                                    poison_corpus)
from repro_torch.kernels import _build
from repro_torch.serve import (AsyncRetrievalEngine, EngineConfig, Request,
                               Supervisor)
from repro_torch.serve import engine as engine_mod

pytestmark = pytest.mark.timeout(300)


def _dataset(C=32, L=6, T=8, M=16, seed=0):
    rng = np.random.default_rng(seed)
    embs = rng.standard_normal((C, L, M)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=-1, keepdims=True)
    mask = np.arange(L)[None] < rng.integers(3, L + 1, C)[:, None]
    q = rng.standard_normal((T, M)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return embs, mask, q


class ManualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ---------------------------------------------------------------------------
# DeadlineBatcher
# ---------------------------------------------------------------------------

def test_batcher_flush_respects_batch_size():
    t = [0.0]
    b = DeadlineBatcher(batch_size=4, deadline_s=1.0, clock=lambda: t[0])
    for x in "abcdef":
        b.add(x)
    assert b.flush() == (["a", "b", "c", "d"], 4)
    assert b.flush() == (["e", "f", "f", "f"], 2)
    assert b.flush() is None


def test_next_expiry_full_batch_expires_now():
    clock = ManualClock()
    b = DeadlineBatcher(batch_size=2, deadline_s=10.0, clock=clock)
    b.add("a")
    assert b.next_expiry() == pytest.approx(10.0)   # partial: window
    b.add("b")
    assert b.next_expiry() == pytest.approx(0.0)    # full: NOW
    clock.advance(3.0)
    assert b.next_expiry() == pytest.approx(3.0)
    assert b.poll() == (["a", "b"], 2)


def test_headroom_is_live_not_frozen_at_add():
    clock = ManualClock()
    headroom = [0.0]
    b = DeadlineBatcher(batch_size=4, deadline_s=10.0, clock=clock,
                        headroom=lambda: headroom[0])
    b.add("a", deadline_abs=1.0)
    assert b.next_expiry() == pytest.approx(1.0)
    headroom[0] = 0.4                     # the service estimate rose
    assert b.next_expiry() == pytest.approx(0.6)
    clock.advance(0.7)
    assert b.poll() is not None


@pytest.mark.parametrize("seed", range(8))
def test_batcher_interleaved_ops_match_jax_and_lose_nothing(seed):
    """A random interleaving of add / poll / flush / clock advances with
    relative and absolute deadlines and a drifting headroom, applied to
    the port's batcher and the JAX package's in lockstep: every call
    returns the same thing, and every item comes back exactly once, in
    FIFO order, with padding never leaking as a real item."""
    rng = np.random.default_rng(seed)
    batch_size = int(rng.integers(1, 6))
    clock = ManualClock()
    headroom = [0.0]
    window = float(rng.uniform(0.1, 2.0))
    ours, theirs = (cls(batch_size=batch_size, deadline_s=window,
                        clock=clock, headroom=lambda: headroom[0])
                    for cls in (DeadlineBatcher, jfault.DeadlineBatcher))
    n_total = int(rng.integers(1, 30))
    added, released = [], []
    i = 0
    while i < n_total or len(ours):
        op = rng.integers(0, 4)
        if op == 0 and i < n_total:
            kind = rng.integers(0, 3)
            kw = ({} if kind == 0 else
                  {"deadline_s": float(rng.uniform(0, 1.0))} if kind == 1
                  else {"deadline_abs": clock() + float(rng.uniform(0, 1))})
            ours.add(i, **kw)
            theirs.add(i, **kw)
            added.append(i)
            i += 1
        elif op == 1 or (op == 2 and rng.random() < 0.3):
            name = "poll" if op == 1 else "flush"
            assert ours.next_expiry() == theirs.next_expiry()
            out = getattr(ours, name)()
            assert out == getattr(theirs, name)()
            if out is not None:
                reqs, n_real = out
                assert len(reqs) == batch_size
                assert reqs[n_real:] == [reqs[n_real - 1]] * (
                    batch_size - n_real)
                released.extend(reqs[:n_real])
        else:
            clock.advance(float(rng.uniform(0, 0.5)))
            headroom[0] = float(rng.uniform(0, 0.3))
    assert released == added              # exactly once, FIFO


# ---------------------------------------------------------------------------
# fault plans, virtual clock, poisoned corpora
# ---------------------------------------------------------------------------

def test_fault_plan_counter_determinism():
    mk = lambda: FaultPlan([
        InjectedFault(point="dispatch", at=3, action="kill"),
        InjectedFault(point="dispatch", at=5, action="shard_down", arg=1),
        InjectedFault(point="admit", at=2, action="delay", arg=0.5),
    ])
    logs = []
    for _ in range(2):
        plan, log = mk(), []
        for t in range(1, 7):
            log.append((t, "admit", [f.action for f in plan.tick("admit")]))
            log.append((t, "dispatch",
                        [f.action for f in plan.tick("dispatch")]))
        logs.append(log)
    assert logs[0] == logs[1]
    fired = {(t, p): a for t, p, a in logs[0] if a}
    assert fired == {(2, "admit"): ["delay"], (3, "dispatch"): ["kill"],
                     (5, "dispatch"): ["shard_down"]}
    assert plan.counts() == {"admit": 6, "dispatch": 6}
    with pytest.raises(ValueError, match="unknown fault action"):
        InjectedFault(point="dispatch", at=1, action="explode")
    with pytest.raises(ValueError, match="tick >= 1"):
        InjectedFault(point="dispatch", at=0, action="kill")


@pytest.mark.parametrize("seed", [7, 8, 123])
def test_fault_plan_seeded_matches_jax_and_kills_sort_last(seed):
    kw = dict(points=("admit", "dispatch", "stream"), n_faults=6,
              actions=("kill", "shard_down", "shard_up", "delay"),
              shards=(0, 1, 3), delay_s=0.25)
    ours = FaultPlan.seeded(seed, **kw)
    theirs = jfault.FaultPlan.seeded(seed, **kw)
    assert ([dataclasses.astuple(f) for f in ours.faults]
            == [dataclasses.astuple(f) for f in theirs.faults])
    assert ours.faults == FaultPlan.seeded(seed, **kw).faults
    plan = FaultPlan([
        InjectedFault(point="dispatch", at=1, action="kill"),
        InjectedFault(point="dispatch", at=1, action="shard_down", arg=0)])
    assert [f.action for f in plan.tick("dispatch")] == ["shard_down",
                                                         "kill"]
    assert not FaultPlan().tick("dispatch") and FaultPlan().empty


def test_chaos_clock_virtual_delay():
    clk = ChaosClock(10.0)
    assert clk() == 10.0
    clk.sleep(2.5)
    assert clk() == 12.5
    t0 = time.monotonic()
    apply_delay(clk, 100.0)                 # virtual: must not wall-sleep
    assert time.monotonic() - t0 < 5.0
    assert clk() == 112.5
    t0 = time.monotonic()
    apply_delay(time.monotonic, 0.05)       # a real clock sleeps
    assert time.monotonic() - t0 >= 0.04


@pytest.mark.parametrize("mode", ["nan", "inf", "neginf"])
def test_poison_corpus_matches_jax_and_copies(mode):
    embs, _, _ = _dataset()
    poisoned, rows = poison_corpus(embs, 0.05, seed=3, mode=mode)
    j_poisoned, j_rows = jfault.poison_corpus(embs, 0.05, seed=3, mode=mode)
    np.testing.assert_array_equal(rows, j_rows)
    np.testing.assert_array_equal(poisoned, j_poisoned)
    assert rows.shape == (embs.shape[0],) and rows.any()
    assert np.isfinite(embs).all()              # input untouched
    assert not np.isfinite(poisoned[rows]).all()
    assert np.array_equal(poisoned[~rows], embs[~rows])
    assert poison_corpus(embs, 0.0)[1].sum() == 0
    with pytest.raises(ValueError, match="unknown poison mode"):
        poison_corpus(embs, 0.1, mode="zero")


# ---------------------------------------------------------------------------
# Supervisor
# ---------------------------------------------------------------------------

def test_supervisor_restarts_within_budget_then_escalates():
    deaths, exhausted = [], []
    sup = Supervisor(max_restarts=2, interval_s=0.005,
                     on_exhausted=lambda n, e: exhausted.append((n, e)))

    def guard():
        deaths.append(1)
        sup.note_failure("worker", ChaosKill("boom"))

    def spawn():
        t = threading.Thread(target=guard, daemon=True)
        t.start()
        return t

    sup.watch("worker", spawn(), factory=spawn)
    sup.start()
    deadline = time.monotonic() + 10.0
    while not exhausted and time.monotonic() < deadline:
        time.sleep(0.01)
    sup.stop()
    assert len(exhausted) == 1
    assert exhausted[0][0] == "worker"
    assert isinstance(exhausted[0][1], ChaosKill)
    assert sup.restarts["worker"] == 2
    assert len(deaths) == 3                     # initial + two restarts
    with pytest.raises(ValueError, match="max_restarts"):
        Supervisor(max_restarts=-1)


# ---------------------------------------------------------------------------
# supervised engine: kills, stop flush, soak
# ---------------------------------------------------------------------------

_CFG = dict(batch_size=2, token_buckets=(8,), cand_buckets=(16,), max_k=5,
            flavor="bandit", alpha_ef=0.3, block_docs=4, block_tokens=2)


def _engine(embs, mask, plan=None, **kw):
    eng = AsyncRetrievalEngine(embs, mask, EngineConfig(**dict(_CFG, **kw)),
                               device="cpu", fault_plan=plan)
    eng.warmup()
    return eng


def _cands(rng, n, C=32):
    return [rng.choice(C, 16, replace=False).astype(np.int32)
            for _ in range(n)]


def test_supervised_dispatch_kill_zero_lost_zero_dup():
    embs, mask, q = _dataset()
    cands = _cands(np.random.default_rng(3), 12)

    def run(plan):
        eng = _engine(embs, mask, plan, pipeline_depth=2, supervise=True,
                      max_thread_restarts=2)
        with eng:
            for c in cands:
                eng.submit(Request(query=q, k=5, cand_ids=c))
            done = eng.drain()
        return eng, done

    plan = FaultPlan([InjectedFault(point="dispatch", at=4, action="kill")])
    eng_f, done_f = run(plan)
    eng_c, done_c = run(None)
    assert [f.action for f in plan.fired] == ["kill"]
    assert eng_f.metrics.summary()["thread_restarts"] == {
        "repro-dispatch": 1}
    for eng, done in ((eng_f, done_f), (eng_c, done_c)):
        rids = [c.rid for c in done]
        assert sorted(rids) == list(range(12))          # zero lost
        assert len(set(rids)) == len(rids)              # zero dup
        assert all(c.error is None for c in done)
        assert eng.metrics.summary()["errors"] == 0
    by_c = {c.rid: c for c in done_c}
    for c in done_f:                                     # served identically
        np.testing.assert_array_equal(c.topk_ids, by_c[c.rid].topk_ids)
        np.testing.assert_array_equal(c.topk_scores,
                                      by_c[c.rid].topk_scores)


def test_supervised_admit_kill_recovers():
    embs, mask, q = _dataset()
    plan = FaultPlan([InjectedFault(point="admit", at=3, action="kill")])
    eng = _engine(embs, mask, plan, flavor="dense", supervise=True)
    with eng:
        for c in _cands(np.random.default_rng(4), 8):
            eng.submit(Request(query=q, k=5, cand_ids=c))
        done = eng.drain()
    assert sorted(c.rid for c in done) == list(range(8))
    assert all(c.error is None for c in done)
    assert eng.metrics.summary()["thread_restarts"] == {"repro-admit": 1}


def test_unsupervised_kill_still_fails_loudly():
    embs, mask, q = _dataset()
    plan = FaultPlan([InjectedFault(point="dispatch", at=1, action="kill")])
    eng = _engine(embs, mask, plan, flavor="dense", supervise=False)
    rids = [eng.submit(Request(query=q, k=5, cand_ids=c))
            for c in _cands(np.random.default_rng(5), 4)]
    eng.start()
    with pytest.raises(RuntimeError, match="serving thread died"):
        eng.drain()
    eng.stop()                   # exception consumed above: stop() flushes
    for rid in rids:
        fut = eng.future(rid)
        assert fut is not None and fut.done()
    assert sorted(c.rid for c in eng.poll()) == sorted(rids)


def test_supervision_budget_exhaustion_escalates():
    embs, mask, q = _dataset()
    plan = FaultPlan([InjectedFault(point="dispatch", at=t, action="kill")
                      for t in (1, 2, 3)])
    eng = _engine(embs, mask, plan, flavor="dense", supervise=True,
                  max_thread_restarts=1, supervise_interval_s=0.005)
    rids = [eng.submit(Request(query=q, k=5, cand_ids=c))
            for c in _cands(np.random.default_rng(6), 4)]
    eng.start()
    with pytest.raises(RuntimeError, match="serving thread died"):
        eng.drain()
    eng.stop()
    assert eng.metrics.summary()["thread_restarts"]["repro-dispatch"] == 1
    assert all(eng.future(r).done() for r in rids)


def test_stop_flushes_queued_work_no_futures_dangle():
    embs, mask, q = _dataset()
    eng = _engine(embs, mask, flavor="dense", batch_size=4,
                  deadline_s=30.0)
    eng.start()
    rids = [eng.submit(Request(query=q, k=5, cand_ids=c))
            for c in _cands(np.random.default_rng(7), 10)]
    eng.stop()                                   # no drain on purpose
    done = eng.poll()
    assert sorted(c.rid for c in done) == sorted(rids)
    assert all(c.error is None for c in done)
    for rid in rids:
        fut = eng.future(rid)
        assert fut.done() and fut.result().rid == rid
    assert eng.metrics.summary()["errors"] == 0


def test_stop_flushes_continuous_stream():
    embs, mask, q = _dataset()
    eng = _engine(embs, mask, continuous=True, stream_trip_limit=2)
    eng.start()
    rids = [eng.submit(Request(query=q, k=5, cand_ids=c))
            for c in _cands(np.random.default_rng(8), 6)]
    eng.stop()
    done = eng.poll()
    assert sorted(c.rid for c in done) == sorted(rids)
    assert all(c.error is None and c.coverage == 1.0 for c in done)


def test_shard_faults_need_a_mesh():
    """Off-mesh a shard fault is a configuration error, as in JAX: the
    chaos hook's shard_down surfaces as the thread's death."""
    embs, mask, q = _dataset()
    plan = FaultPlan([InjectedFault(point="dispatch", at=1,
                                    action="shard_down", arg=0)])
    eng = _engine(embs, mask, plan, flavor="dense")
    assert eng.shard_health() is None
    with pytest.raises(ValueError, match="needs a mesh-resident corpus"):
        eng.fail_shard(0)
    eng.submit(Request(query=q, k=5, cand_ids=np.arange(16)))
    eng.start()
    with pytest.raises(RuntimeError, match="serving thread died") as err:
        eng.drain()
    assert isinstance(err.value.__cause__, ValueError)
    eng.stop()


def _soak_inputs(seed, C=47, L=6, M=8, T=8, n_q=32):
    rng = np.random.default_rng(seed)
    embs = rng.standard_normal((C, L, M)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=-1, keepdims=True)
    mask = np.arange(L)[None] < rng.integers(3, L + 1, C)[:, None]
    qs = rng.standard_normal((n_q, T, M)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    return rng, embs, mask, qs


def test_chaos_soak_single_device_zero_lost_zero_dup():
    """300 requests through a supervised engine while a replayable plan
    kills the dispatch thread and stalls it, with 1% of the corpus
    NaN-poisoned: zero lost, zero duplicated, no error completions,
    poisoned docs quarantined out of every top-K, all served scores
    finite, and the watchdog's counters show the faults fired."""
    rng, embs, mask, qs = _soak_inputs(0)
    N = 300
    poisoned, rows = poison_corpus(embs, 0.01, seed=11, mode="nan")
    bad = int(np.flatnonzero(rows)[0])
    # The dispatch loop ticks at least once per batch (N / 8 = 38).
    plan = FaultPlan([
        InjectedFault(point="dispatch", at=10, action="kill"),
        InjectedFault(point="dispatch", at=25, action="delay", arg=0.01),
    ])
    eng = AsyncRetrievalEngine(poisoned, mask, EngineConfig(
        batch_size=8, deadline_s=0.05, token_buckets=(8,),
        cand_buckets=(16,), max_k=5, flavor="dense", pipeline_depth=2,
        supervise=True, max_thread_restarts=2), device="cpu",
        fault_plan=plan)
    eng.warmup()
    with eng:
        for i in range(N):
            cand = rng.choice(47, 16, replace=False).astype(np.int32)
            if i % 10 == 0 and bad not in cand:
                cand[0] = bad               # keep the poisoned doc in play
            eng.submit(Request(query=qs[i % 32], k=5, cand_ids=cand))
        done = eng.drain()
    rids = [c.rid for c in done]
    assert sorted(rids) == list(range(N)), "lost completions"
    assert len(set(rids)) == N, "duplicated completions"
    assert all(c.error is None for c in done)
    for c in done:
        assert c.coverage == 1.0
        assert bad not in c.topk_ids.tolist(), (c.rid, c.topk_ids)
        assert np.isfinite(c.topk_scores[c.topk_ids >= 0]).all()
    s = eng.metrics.summary()
    assert s["errors"] == 0 and s["compiles_after_warmup"] == 0
    assert s["thread_restarts"] == {"repro-dispatch": 1}, s
    assert s["quarantined_total"] > 0, s
    assert [f.action for f in plan.fired] == ["kill", "delay"]


def test_empty_fault_plan_is_bit_identical_to_no_plan():
    rng, embs, mask, qs = _soak_inputs(1)
    cands = [rng.choice(47, 16, replace=False).astype(np.int32)
             for _ in range(32)]

    def run(plan):
        eng = AsyncRetrievalEngine(embs, mask, EngineConfig(
            batch_size=8, deadline_s=30.0, token_buckets=(8,),
            cand_buckets=(16,), max_k=5, flavor="bandit", alpha_ef=0.3,
            block_docs=4, block_tokens=2, supervise=True), device="cpu",
            fault_plan=plan)
        eng.warmup()
        with eng:
            for i, c in enumerate(cands):
                eng.submit(Request(query=qs[i % 16], k=5, cand_ids=c))
            return {c.rid: c for c in eng.drain()}

    a, b = run(FaultPlan()), run(None)
    assert sorted(a) == sorted(b) == list(range(32))
    for rid in a:
        np.testing.assert_array_equal(a[rid].topk_ids, b[rid].topk_ids)
        np.testing.assert_array_equal(a[rid].topk_scores, b[rid].topk_scores)


# ---------------------------------------------------------------------------
# the engine's thread-safety contract
# ---------------------------------------------------------------------------

def test_engine_guarded_by_tables_pass_the_lockset_lint():
    assert locks.check_file(engine_mod.__file__) == []


def test_recorder_sanitized_soak_no_undeclared_shared_state():
    """The JAX package's runtime thread-access sanitizer on the port's
    engine: a supervised run through a thread kill touches no cross-thread
    attribute outside GUARDED_BY."""
    rng, embs, mask, qs = _soak_inputs(3)
    plan = FaultPlan([InjectedFault(point="dispatch", at=3, action="kill")])
    eng = AsyncRetrievalEngine(embs, np.ones(mask.shape, bool), EngineConfig(
        batch_size=8, deadline_s=0.02, token_buckets=(8,),
        cand_buckets=(16,), max_k=4, flavor="dense", supervise=True,
        max_thread_restarts=2), device="cpu", fault_plan=plan)
    eng.warmup()
    rec = ThreadAccessRecorder(eng, declared=set(engine_mod.GUARDED_BY))
    with rec:
        with eng:
            for i in range(48):
                cand = rng.choice(47, 16, replace=False).astype(np.int32)
                eng.submit(Request(query=qs[i % 8], k=4, cand_ids=cand))
            done = eng.drain()
    assert sorted(c.rid for c in done) == list(range(48))
    assert [f.action for f in plan.fired] == ["kill"]
    assert rec.violations() == [], rec.violations()
    assert "_completed" in rec.shared()


# ---------------------------------------------------------------------------
# kernel loading and launch counts under threads
# ---------------------------------------------------------------------------

class _YieldingCounts(dict):
    """Launch counts whose reads give up the interpreter lock, so an
    unlocked read-modify-write of a count would lose updates."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


class _FakeLib:
    """A loaded library whose entry points accept argtypes/restype."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        fn = type("_Fn", (), {})()
        object.__setattr__(self, name, fn)
        return fn


def test_kernel_library_loads_once_and_counts_every_launch(monkeypatch):
    """8 threads race a cold ``library()`` and then count launches: one
    build and one load per library, and no increment lost."""
    builds, loads = [], []

    def slow_build(sources=None):
        builds.append(tuple(sources))
        time.sleep(0.05)             # a long compile widens the race
        return 0.0

    def load(path):
        loads.append(path)
        return _FakeLib(path)

    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(ctypes, "CDLL", load)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "LAUNCHES",
                        _YieldingCounts.fromkeys(_build.LAUNCHES, 0))
    n_threads, n_launches = 8, 500
    start = threading.Barrier(n_threads)
    got = [None] * n_threads

    def worker(i):
        start.wait()
        got[i] = (_build.library("reveal.cu"), _build.library("maxsim.cu"))
        for _ in range(n_launches):
            _build.check_launch(0, "fused_reveal")
            _build.check_launch(0, "maxsim")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert sorted(builds) == [("maxsim.cu",), ("reveal.cu",)]
    assert len(loads) == 2
    assert all(g == got[0] for g in got)
    assert _build.LAUNCHES["fused_reveal"] == n_threads * n_launches
    assert _build.LAUNCHES["maxsim"] == n_threads * n_launches
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.check_launch(700, "maxsim")
    assert _build.LAUNCHES["maxsim"] == n_threads * n_launches
    _build.reset_launches()
    assert not any(_build.LAUNCHES.values())
