"""The reader of ``graph_trip_share.p95``: the share of the bandit
batches' trips that replayed a captured trip graph, read from the
program's ``graph_trips`` and ``trips`` counters; None where the program
counts no ``graph_trips`` (the parent's) or no trip."""
import types

import pytest

from perfbench.harness import program_spans as ps
from perfbench.harness import spec
from repro_torch import spans
from repro_torch.serve import BatchRecord

CELL = "text-stage1-open"
READER = "graph_trip_share.p95"


def _batch(flavor, trips, graph_trips, n_real=16):
    st = spans.new()
    st[spans.STEP], st[spans.STEP + 1], st[spans.STEP + 2] = 1, 10, 20
    st[spans.TRIPS] = trips
    st[spans.GRAPH_TRIPS] = graph_trips
    return BatchRecord(bucket=(32, 256), flavor=flavor, n_real=n_real,
                       occupancy=1.0, service_s=0.0, reveal_fraction=0.4,
                       stamps=st)


def _run(batches):
    return types.SimpleNamespace(batches=batches, t0=0.0, t_end=1.0,
                                 trace=None, profiled=None)


def test_the_stage1_cell_reports_it():
    cell = spec.cell(CELL)
    assert READER in {m["name"] for m in cell.per_layer}
    assert READER not in {m["name"] for m in
                          spec.cell("text-bandit-256").per_layer}


def test_graph_trip_share_reader(monkeypatch):
    monkeypatch.setattr(ps, "clock_offset_ns", lambda: 0)
    bs = [_batch("bandit", 80, 80), _batch("bandit", 70, 0),
          _batch("dense", 0, 0)]
    assert spec.reader(READER).read(_run(bs)) == pytest.approx(80 / 150)
    assert spec.reader(READER).read(_run(bs[:1])) == pytest.approx(1.0)
    assert spec.reader(READER).read(_run(bs[2:])) is None


def test_graph_trip_share_reader_without_the_counter(monkeypatch):
    """The parent's program: its records carry no ``graph_trips`` (it is
    not among its counters), or no stamps at all."""
    monkeypatch.setattr(ps, "clock_offset_ns", lambda: 0)
    bs = [_batch("bandit", 80, 0)]
    monkeypatch.setattr(spans, "COUNTERS", tuple(
        c for c in spans.COUNTERS if c != "graph_trips"))
    assert spec.reader(READER).read(_run(bs)) is None
    monkeypatch.undo()
    old = types.SimpleNamespace(flavor="bandit", n_real=16, stamps=None)
    assert spec.reader(READER).read(_run([old])) is None
