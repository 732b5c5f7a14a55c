"""The pooled bandit's trips launched through a trip graph
(``core/frontier.py::TripGraph``, ``TripGraphs``).

On the CPU the graph path runs with its stand-in: every operand a trip
reads is staged into the graph's buffers, the first run's ``fused_trip``
is kept where the card captures it, and every later "replay" calls that
same closure on the buffers. So a run is only right here if each value a
trip reads is staged by the current run, which is what a replay on the
card reads too.

  * the static-buffer path gives the eager run's ``PooledResult`` bit for
    bit (topk, s_hat, rounds, trips, occupancy, lockstep_waste, reveals,
    quarantined) at Q = 16 and 32, T = 32 and 64, with padded candidate
    rows and an alpha scale of 1 and 2, for a second and third batch
    through one cache; the first batch's outputs are unchanged after the
    next ones ran (no output aliases a buffer);
  * ``graph_trips`` counts every trip of a captured shape and none of an
    uncaptured one, of another alpha scale, of the chain body or of a run
    under a dispatch mode (the audit's recorder);
  * threads running one captured shape at once each get their batch's
    eager answer (the graph's lock);
  * under torch's profiler a captured shape's trips run eagerly on the
    graph's buffers (no ``graph_trips``) with the same answers, and replay
    again once it has stopped;
  * the engine captures at warm-up only: a warmed sync engine serves every
    bandit batch through the graph with the eager engine's answers, an
    async engine started before any build never captures.

On the card (``cuda`` marker, run on the H100: ``pytest -m cuda
tests/test_torch_trip_graph.py``): capture then replay equals the eager
step bit for bit at text and page widths, ``graph_trips`` equals ``trips``
for a warmed shape and is 0 for an unwarmed one, and ``LAUNCHES`` counts
the same either way; and torch's profiler, switched on and off while
another thread serves batches of a captured shape, stops every time, its
batches getting the eager step's answers.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.analysis.audit import Recorder
from repro_torch.core.batched import BatchedConfig
from repro_torch.core import frontier
from repro_torch.core.frontier import TripGraphs, run_pooled_bandit
from repro_torch.kernels import _build
from repro_torch.retrieval import service
from repro_torch.serve import (AsyncRetrievalEngine, EngineConfig, Request,
                               RetrievalEngine)
from repro_torch.serve import engine as engine_mod
from test_torch_threads import cap_torch_threads

cap_torch_threads()

pytestmark = pytest.mark.timeout(300)

K, M = 5, 16
RESULT_FIELDS = ("topk", "s_hat", "rounds", "trips", "occupancy",
                 "lockstep_waste", "reveals", "quarantined")


def _unit(x):
    return x / x.norm(dim=-1, keepdim=True)


def _corpus(C=96, L=20, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    embs = _unit(torch.randn(C, L, M, generator=g))
    lens = torch.randint(6, L + 1, (C,), generator=g)
    mask = torch.arange(L)[None, :] < lens[:, None]
    return (embs * mask[:, :, None]).to(device), mask.to(device)


def _batch(Q, T, N=24, C=96, seed=1):
    """Q queries of T tokens, N candidates each (two rows padded, which
    two by the seed), per-cell bounds around [0, 1] drawn by the seed,
    per-query seeds: every operand differs from batch to batch."""
    g = torch.Generator().manual_seed(seed)
    queries = _unit(torch.randn(Q, T, M, generator=g))
    cand = torch.stack([torch.randperm(C, generator=g)[:N]
                        for _ in range(Q)])
    cand[seed % Q, N // 3:] = -1
    cand[Q - 1 - seed % Q, 5 + seed:] = -1
    a = -0.3 * torch.rand((Q, N, T), generator=g)
    b = 1.0 + 0.3 * torch.rand((Q, N, T), generator=g)
    seeds = torch.arange(Q, dtype=torch.int64) * 3 + seed
    return queries, cand, a, b, seeds


class _Results:
    """Keeps the ``PooledResult`` of every run the steps make."""

    def __init__(self, monkeypatch):
        self.runs = []
        real = service.run_pooled_bandit

        def spy(*args, **kw):
            res = real(*args, **kw)
            self.runs.append(res)
            return res

        monkeypatch.setattr(service, "run_pooled_bandit", spy)


def _counted(fn):
    st = spans.new()
    prev = spans.open_batch(st)
    try:
        return fn(), st
    finally:
        spans.open_batch(prev)


def _same(x, y):
    if isinstance(x, (tuple, list)):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            _same(u, v)
    else:
        assert torch.equal(x, y), (x, y)


def _fields(res):
    return tuple(getattr(res, f) for f in RESULT_FIELDS)


def _clone(xs):
    return tuple(x.clone() for x in xs)


@pytest.mark.parametrize("alpha_scale", [1.0, 2.0])
@pytest.mark.parametrize("Q,T", [(16, 32), (32, 64)])
def test_static_buffers_equal_the_eager_run(Q, T, alpha_scale, monkeypatch):
    embs, mask = _corpus()
    graphs = TripGraphs(stand_in=True)
    kw = dict(topk=K, alpha_ef=0.2)
    graphed = service.make_serving_step("bandit", trip_graphs=graphs, **kw)
    eager = service.make_serving_step("bandit", **kw)
    results = _Results(monkeypatch)
    batches = [_batch(Q, T, seed=s) for s in (1, 2, 3)]

    def run(step, batch):
        q, cand, a, b, seeds = batch
        return _counted(lambda: step(embs, mask, q, cand, a, b, seeds,
                                     alpha_scale=alpha_scale))

    with graphs.capturing():
        first, st = run(graphed, batches[0])
    assert len(graphs.captured()) == 1
    first_res = _clone(_fields(results.runs[-1]))
    first_out = _clone(first)
    trips = [spans.counter(st, "trips")]
    assert trips[0] > 0 and spans.counter(st, "graph_trips") == trips[0]
    for batch in batches[1:]:
        got, st = run(graphed, batch)
        got_res = _fields(results.runs[-1])
        want, st_eager = run(eager, batch)
        _same(got, want)
        _same(got_res, _fields(results.runs[-1]))
        assert spans.counter(st, "graph_trips") == spans.counter(
            st, "trips") == spans.counter(st_eager, "trips") > 0
        assert spans.counter(st_eager, "graph_trips") == 0
        for name in ("reads", "reveal_rows"):
            assert spans.counter(st, name) == spans.counter(st_eager, name)
        trips.append(spans.counter(st, "trips"))
    # The first batch's outputs, taken as the step returned them, are
    # still its own (and the eager run's) after two more batches.
    _same(first, first_out)
    _same(first_res, _fields(results.runs[0]))
    want, _ = run(eager, batches[0])
    _same(first, want)
    _same(first_res, _fields(results.runs[-1]))
    assert float(first[2].min()) < 1.0       # the bandit stopped early


def test_graph_engages_only_where_captured(monkeypatch):
    embs, mask = _corpus()
    graphs = TripGraphs(stand_in=True)
    graphed = service.make_serving_step("bandit", topk=K, alpha_ef=0.2,
                                        trip_graphs=graphs)
    eager = service.make_serving_step("bandit", topk=K, alpha_ef=0.2)
    q, cand, a, b, seeds = _batch(16, 32)

    def graph_trips(step, *args, **kw):
        out, st = _counted(lambda: step(embs, mask, *args, **kw))
        return out, spans.counter(st, "graph_trips"), spans.counter(
            st, "trips")

    # Not armed: nothing is captured, the run is eager.
    _, n, trips = graph_trips(graphed, q, cand, a, b, seeds)
    assert n == 0 < trips and graphs.captured() == []
    with graphs.capturing():
        graph_trips(graphed, q, cand, a, b, seeds)
    assert len(graphs.captured()) == 1
    cases = {
        # another shape (T = 64): never captured
        "shape": (_batch(16, 64)[:5], {}),
        # another alpha scale: the capture holds the scale it read
        "alpha": ((q, cand, a, b, seeds), dict(alpha_scale=2.0)),
        # a host 0-d tensor scale keys the graph as its number does
        "alpha tensor": ((q, cand, a, b, seeds),
                         dict(alpha_scale=torch.tensor(1.0))),
    }
    for name, (args, kw) in cases.items():
        got, n, trips = graph_trips(graphed, *args, **kw)
        want = eager(embs, mask, *args, **kw)
        _same(got, want)
        # a CPU tensor is read on the host: it keys the captured graph
        assert n == (trips if name == "alpha tensor" else 0), name
    # The captured shape replays; under a dispatch mode (the audit's
    # recorder) it runs eagerly, so the recorder sees every trip's ops.
    _, n, trips = graph_trips(graphed, q, cand, a, b, seeds)
    assert n == trips > 0
    with Recorder() as rec:
        _, n, trips = graph_trips(graphed, q, cand, a, b, seeds)
    assert n == 0 and rec.trips == trips > 0
    # The chain body has no graph.
    chain = service.make_serving_step("bandit", topk=K, alpha_ef=0.2,
                                      engine="pooled_chain",
                                      trip_graphs=graphs)
    with graphs.capturing():
        _, n, trips = graph_trips(chain, q, cand, a, b, seeds)
    assert n == 0 < trips and len(graphs.captured()) == 1


def test_threads_share_one_graph_one_run_at_a_time():
    """Threads running batches of one captured shape at once (more threads
    than cores, a short switch interval): each gets its own batch's eager
    answer, as the graph's lock lets one run at a time stage and loop."""
    embs, mask = _corpus()
    graphs = TripGraphs(stand_in=True)
    graphed = service.make_serving_step("bandit", topk=K, alpha_ef=0.2,
                                        trip_graphs=graphs)
    eager = service.make_serving_step("bandit", topk=K, alpha_ef=0.2)
    batches = [_batch(16, 32, seed=s) for s in range(1, 7)]
    want = [eager(embs, mask, *b) for b in batches]
    with graphs.capturing():
        graphed(embs, mask, *batches[0])
    n_threads = 2 * (os.cpu_count() or 4)
    got, errors = {}, []

    def work(i):
        try:
            for j in range(2):
                k = (i + j) % len(batches)
                got[(i, j)] = (k, graphed(embs, mask, *batches[k]))
        except Exception as e:              # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(got) == 2 * n_threads
    for k, out in got.values():
        _same(out, want[k])


def test_profiled_trips_run_eagerly_on_the_buffers():
    """While torch's profiler is on (whose device tracing deadlocks its own
    stop against a graph launched on another thread), a captured shape's
    trips run the captured trip eagerly on the same buffers: the eager
    answers, no graph trips; replays resume once it has stopped."""
    embs, mask = _corpus()
    graphs = TripGraphs(stand_in=True)
    graphed = service.make_serving_step("bandit", topk=K, alpha_ef=0.2,
                                        trip_graphs=graphs)
    eager = service.make_serving_step("bandit", topk=K, alpha_ef=0.2)
    batches = [_batch(16, 32, seed=s) for s in (1, 2, 3)]
    with graphs.capturing():
        graphed(embs, mask, *batches[0])
    assert not frontier._profiled()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert frontier._profiled()
        got, st = _counted(lambda: graphed(embs, mask, *batches[1]))
    assert not frontier._profiled()
    _same(got, eager(embs, mask, *batches[1]))
    assert spans.counter(st, "graph_trips") == 0 < spans.counter(st, "trips")
    got, st = _counted(lambda: graphed(embs, mask, *batches[2]))
    _same(got, eager(embs, mask, *batches[2]))
    assert spans.counter(st, "graph_trips") == spans.counter(
        st, "trips") > 0


def test_graph_rejects_other_bodies():
    graph_cache = TripGraphs(stand_in=True)
    with graph_cache.capturing():
        with graph_cache.use(("k",), torch.device("cpu")) as graph:
            for kw in (dict(fused=False), dict(trip_limit=2),
                       dict(return_state=True)):
                with pytest.raises(ValueError, match="fused one-shot"):
                    run_pooled_bandit(None, torch.zeros((1, 2, 2)),
                                      torch.ones((1, 2, 2)),
                                      torch.zeros((1,), dtype=torch.int64),
                                      BatchedConfig(k=1), graph=graph, **kw)


# ---------------------------------------------------------------------------
# the engine: capture at warm-up only
# ---------------------------------------------------------------------------

def _engine_cfg(**kw):
    base = dict(batch_size=4, deadline_s=30.0, token_buckets=(16,),
                cand_buckets=(24,), max_k=K, flavor="bandit",
                bandit_min_candidates=8, alpha_ef=0.2, block_docs=4,
                block_tokens=4)
    base.update(kw)
    return EngineConfig(**base)


def _requests(n=8, seed=5):
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    return [Request(query=_unit(torch.randn(16 - i % 3, M, generator=g))
                    .numpy(), k=K,
                    cand_ids=rng.choice(96, 24 - 2 * (i % 4),
                                        replace=False).astype(np.int32))
            for i in range(n)]


def _answers(comps):
    return [(c.rid, c.topk_ids.tolist(), c.topk_scores.tolist())
            for c in sorted(comps, key=lambda c: c.rid)]


def test_warmed_sync_engine_serves_through_the_graph(monkeypatch):
    embs, mask = _corpus()
    reqs = _requests()
    plain = RetrievalEngine(embs, mask, _engine_cfg(), device="cpu")
    plain.warmup()
    for r in reqs:
        plain.submit(r)
    want = _answers(plain.drain())
    made = []

    def stand_in():
        made.append(TripGraphs(stand_in=True))
        return made[-1]

    monkeypatch.setattr(engine_mod, "TripGraphs", stand_in)
    eng = RetrievalEngine(embs, mask, _engine_cfg(), device="cpu")
    eng.warmup()
    assert len(made) == 1 and len(made[0].captured()) == 1
    for r in reqs:
        eng.submit(r)
    assert _answers(eng.drain()) == want
    batches = eng.metrics.batches
    assert len(batches) == 2 and eng.metrics.compiles_after_warmup == 0
    for b in batches:
        assert b.counter("graph_trips") == b.counter("trips") > 0


def test_async_engine_started_unwarmed_never_captures(monkeypatch):
    embs, mask = _corpus()
    made = []

    def stand_in():
        made.append(TripGraphs(stand_in=True))
        return made[-1]

    monkeypatch.setattr(engine_mod, "TripGraphs", stand_in)
    eng = AsyncRetrievalEngine(embs, mask, _engine_cfg(), device="cpu")
    eng.start()
    try:
        futs = [eng.future(eng.submit(r)) for r in _requests(4)]
        comps = [f.result(timeout=120) for f in futs]
    finally:
        eng.stop()
    assert all(c.error is None for c in comps)
    assert len(made) == 1 and made[0].captured() == []
    assert all(b.counter("graph_trips") == 0 < b.counter("trips")
               for b in eng.metrics.batches)


# ---------------------------------------------------------------------------
# on the card (run on the H100: pytest -m cuda tests/test_torch_trip_graph.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the H100: pytest -m cuda "
                    "tests/test_torch_trip_graph.py)")
    return torch.device("cuda")


WIDTHS = {
    # (Q, T, L, ragged): ColBERTv2 text and Granite Vision Embedding pages
    "text": (16, 32, 128, True),
    "page": (32, 64, 729, False),
}


def _card_inputs(card, Q, T, L, ragged, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    C, N, Mc = 2048, 256, 128
    embs = _unit(torch.randn((C, L, Mc), generator=g, device=card))
    lens = (torch.randint(32, L + 1, (C,), generator=g, device=card)
            if ragged else torch.full((C,), L, device=card))
    mask = torch.arange(L, device=card)[None, :] < lens[:, None]
    batches = []
    for s in range(3):
        queries = _unit(torch.randn((Q, T, Mc), generator=g, device=card))
        cand = torch.stack([torch.randperm(C, generator=g,
                                           device=card)[:N]
                            for _ in range(Q)])
        cand[1, 200:] = -1
        cand[Q - 1 - s, 100 + 40 * s:] = -1
        a = -0.3 * torch.rand((Q, N, T), generator=g, device=card)
        b = 1.0 + 0.3 * torch.rand((Q, N, T), generator=g, device=card)
        seeds = torch.arange(Q, dtype=torch.int64, device=card) + 5 + s
        batches.append((queries, cand, a, b, seeds))
    return embs * mask[:, :, None], mask, batches


@pytest.mark.cuda
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_card_replay_equals_eager_bit_for_bit(card, width):
    Q, T, L, ragged = WIDTHS[width]
    embs, mask, batches = _card_inputs(card, Q, T, L, ragged, seed=3)
    graphs = TripGraphs()
    kw = dict(topk=K, alpha_ef=0.2)
    graphed = service.make_serving_step("bandit", trip_graphs=graphs, **kw)
    eager = service.make_serving_step("bandit", **kw)

    def run(step, batch):
        def go():
            _build.reset_launches()
            out = tuple(x.cpu() for x in step(embs, mask, *batch))
            return out, _build.launch_counts()
        return _counted(go)

    with graphs.capturing():
        (first, _), st = run(graphed, batches[0])
    assert len(graphs.captured()) == 1
    assert spans.counter(st, "graph_trips") == spans.counter(st, "trips")
    for batch in batches[1:] + batches[:1]:
        (got, got_n), st = run(graphed, batch)
        (want, want_n), st_eager = run(eager, batch)
        _same(got, want)
        assert got_n == want_n and got_n["fused_reveal"] == 1 + \
            spans.counter(st, "trips")
        assert spans.counter(st, "graph_trips") == spans.counter(
            st, "trips") == spans.counter(st_eager, "trips") > 0
        assert spans.counter(st_eager, "graph_trips") == 0
    _same(first, run(eager, batches[0])[0][0])
    # An unwarmed shape (Q - 1 queries) replays nothing.
    small = tuple(x[:-1] for x in batches[0])
    (got, got_n), st = run(graphed, small)
    (want, want_n), _ = run(eager, small)
    _same(got, want)
    assert got_n == want_n
    assert spans.counter(st, "graph_trips") == 0 < spans.counter(st, "trips")


@pytest.mark.cuda
def test_card_engine_serves_through_the_graph(card, monkeypatch):
    Q, T, L, ragged = WIDTHS["text"]
    embs, mask, _ = _card_inputs(card, Q, T, L, ragged, seed=4)
    rng = np.random.default_rng(2)
    g = torch.Generator().manual_seed(2)
    reqs = [Request(query=_unit(torch.randn(T, 128, generator=g)).numpy(),
                    k=K, cand_ids=rng.choice(2048, 256 - 40 * (i % 2),
                                             replace=False).astype(np.int32))
            for i in range(2 * Q)]
    cfg = dict(batch_size=Q, deadline_s=30.0, token_buckets=(T,),
               cand_buckets=(256,), max_k=K, flavor="bandit",
               bandit_min_candidates=64, alpha_ef=0.2)

    def serve(eng):
        eng.warmup()
        for r in reqs:
            eng.submit(r)
        return _answers(eng.drain()), eng.metrics.batches

    got, batches = serve(RetrievalEngine(embs, mask, EngineConfig(**cfg),
                                         device=card))
    assert all(b.counter("graph_trips") == b.counter("trips") > 0
               for b in batches)
    monkeypatch.setattr(engine_mod, "TripGraphs", lambda: None)
    want, batches = serve(RetrievalEngine(embs, mask, EngineConfig(**cfg),
                                          device=card))
    assert all(b.counter("graph_trips") == 0 for b in batches)
    assert got == want


@pytest.mark.cuda
def test_card_profiler_stops_while_another_thread_replays(card):
    """torch's profiler with device tracing, switched on and off while a
    serving thread runs batches of a captured shape, stops each time; the
    trips run while it was on ran eagerly, the others replayed, and every
    answer is the eager step's."""
    from torch.profiler import ProfilerActivity, profile
    Q, T, L, ragged = WIDTHS["text"]
    embs, mask, batches = _card_inputs(card, Q, T, L, ragged, seed=5)
    graphs = TripGraphs()
    kw = dict(topk=K, alpha_ef=0.2)
    graphed = service.make_serving_step("bandit", trip_graphs=graphs, **kw)
    eager = service.make_serving_step("bandit", **kw)
    want = [tuple(x.cpu() for x in eager(embs, mask, *b)) for b in batches]
    with graphs.capturing():
        graphed(embs, mask, *batches[0])
    stop = threading.Event()
    served, errors = [], []

    def serve():
        try:
            i = 0
            while not stop.is_set():
                k = i % len(batches)
                out, st = _counted(lambda: tuple(
                    x.cpu() for x in graphed(embs, mask, *batches[k])))
                served.append((k, out, spans.counter(st, "graph_trips"),
                               spans.counter(st, "trips")))
                i += 1
        except Exception as e:              # reported by the main thread
            errors.append(e)

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    try:
        for _ in range(4):
            time.sleep(0.2)
            with profile(activities=[ProfilerActivity.CUDA]):
                time.sleep(0.3)
    finally:
        stop.set()
        th.join(timeout=120)
    assert not th.is_alive() and not errors, errors
    assert any(n < trips for _, _, n, trips in served)
    assert any(n == trips > 0 for _, _, n, trips in served)
    for k, out, _, _ in served:
        _same(out, want[k])
