"""The traffic loops against a fake engine that answers after a fixed
service time on a thread of its own."""
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from perfbench.harness.client import Record
from perfbench.harness.context import Run
from perfbench.traffic import closed_loop, open_loop


class FakeEngine:
    """Answers each request ``service_s`` after it was sent; fails every
    ``fail_every``-th and refuses every ``refuse_every``-th at submit."""

    def __init__(self, service_s, fail_every=0, refuse_every=0):
        self.service_s = service_s
        self.fail_every, self.refuse_every = fail_every, refuse_every
        self.lock = threading.Lock()
        self.outstanding = self.max_outstanding = 0
        self.timers = []

    def send(self, rec: Record):
        rec.sent = time.perf_counter()
        if self.refuse_every and rec.i % self.refuse_every == 1:
            rec.error, rec.done = "refused", time.perf_counter()
            return None
        fut = Future()
        with self.lock:
            self.outstanding += 1
            self.max_outstanding = max(self.max_outstanding,
                                       self.outstanding)

        def answer():
            with self.lock:
                self.outstanding -= 1
            rec.done = time.perf_counter()
            if self.fail_every and rec.i % self.fail_every == 0:
                rec.error = "error answer"
            rec.completion = object()
            fut.set_result(rec.completion)

        t = threading.Timer(self.service_s, answer)
        self.timers.append(t)
        t.start()
        return fut

    def join(self):
        for t in self.timers:
            t.join(timeout=5)
            assert not t.is_alive()


def test_closed_loop_keeps_outstanding():
    eng = FakeEngine(0.02)
    recs = closed_loop.run(eng.send, {"outstanding": 8}, 0.5, None,
                           time.perf_counter)
    eng.join()
    assert eng.max_outstanding == 8
    # 8 clients x 0.5 s / 0.02 s, less the scheduling slack
    assert 60 <= len(recs) <= 8 * 26
    assert [r.i for r in recs] == list(range(len(recs)))
    lat = [r.done - r.intended for r in recs if r.ok]
    assert 0.02 <= np.median(lat) < 0.06


def test_open_loop_sends_on_schedule_whatever_the_answers():
    rng = np.random.default_rng(3)
    sched = open_loop.schedule(40.0, 1.0, rng)
    assert len(sched) == 40 and 0 < sched[0] and sched[-1] < 1.0
    eng = FakeEngine(0.3)                # slower than the gaps: a backlog
    t0 = time.perf_counter()
    recs = open_loop.run(eng.send, {"rate_per_s": 40.0}, 1.0,
                         np.random.default_rng(3), time.perf_counter)
    assert time.perf_counter() - t0 == pytest.approx(1.0, abs=0.25)
    eng.join()
    assert len(recs) == 40 and eng.max_outstanding > 5
    for r, off in zip(recs, sched):
        assert r.intended == pytest.approx(t0 + off, abs=0.02)
    lag = sorted(r.sent - r.intended for r in recs)
    assert lag[len(lag) // 2] < 0.02            # the generator kept time


def test_same_gaps_for_every_seed():
    g = open_loop.gaps(30.0, 2.0)
    assert len(g) == 60 and g.sum() == pytest.approx(2.0)
    a = open_loop.schedule(30.0, 2.0, np.random.default_rng(1))
    b = open_loop.schedule(30.0, 2.0, np.random.default_rng(2))
    assert not np.allclose(a, b)                     # another order
    for off in (a, b):
        d = np.diff(np.r_[0.0, off])
        d[0] += g[0] / 2
        assert np.allclose(np.sort(d), g)            # the same gaps


def _run(recs, seconds, t_end):
    return Run(cell=None, seed=0, seconds=seconds, setup_s=0.0, t0=0.0,
               t_end=t_end, records=recs, batches=[], n_served=0,
               launches={}, trace=None, memory_peak_bytes=0, inputs=None)


def test_failures_count_as_missing_latency():
    eng = FakeEngine(0.01, fail_every=4, refuse_every=5)
    recs = closed_loop.run(eng.send, {"outstanding": 4}, 0.3, None,
                           time.perf_counter)
    eng.join()
    failed = [r for r in recs if not r.ok]
    assert failed and all(r.latency_s == float("inf") for r in failed)
    run = _run(recs, 0.3, max(r.done for r in recs) + 1)
    share = len(failed) / len(recs)
    if share > 0.05:
        assert run.latency_quantile_ms(0.95) is None   # the tail failed
    assert len(run.completed_in_window()) == len(recs) - len(failed)
