"""The page cell ``mm-bandit-256`` (Granite Vision Embedding widths): it
resolves by name at its stated widths; its reader of ``reveal_rows`` reads
the program's counter and returns None where the program counts none; and
a whole run at page shapes on the CPU (64-token queries, every page a
fixed 45 tokens) comes out correct, and not correct with a wrong top-5."""
import time
import types

import pytest
import torch

from conftest import SEED, shrink
from perfbench import run as bench
from perfbench.harness import program_spans as ps
from perfbench.harness import spec
from repro_torch import spans
from repro_torch.serve import BatchRecord
from test_perfbench_faults import _correct, topk_wrong

CELL = "mm-bandit-256"
READER = "reveal_rows_per_query.overlap"


def test_the_page_cell_resolves_at_its_widths():
    cell = spec.cell(CELL)
    c = cell.config
    assert (c["query_tokens"], c["doc_tokens"], c["min_doc_tokens"],
            c["dim"], c["dtype"]) == (64, 729, 729, 128, "float32")
    assert c["n_docs"] == 185714 and c["reduced"]["n_docs"]["published"] \
        == 2600000
    assert cell.workload["engine"]["token_buckets"] == [64]
    assert {m["name"] for m in cell.end_to_end} == {"overlap_at_5",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {"reveal_fraction.overlap",
                                                   READER}


def _batch(flavor, rows, n_real):
    st = spans.new()
    st[spans.STEP], st[spans.STEP + 1], st[spans.STEP + 2] = 1, 10, 20
    st[spans.REVEAL_ROWS] = rows
    return BatchRecord(bucket=(64, 256), flavor=flavor, n_real=n_real,
                       occupancy=1.0, service_s=0.0, reveal_fraction=0.3,
                       stamps=st)


def _run(batches):
    return types.SimpleNamespace(batches=batches, t0=0.0, t_end=1.0,
                                 trace=None, profiled=None)


def test_reveal_rows_reader(monkeypatch):
    monkeypatch.setattr(ps, "clock_offset_ns", lambda: 0)
    bs = [_batch("bandit", 32 * 256 + 100 * 256, 32),
          _batch("bandit", 16 * 256 + 40 * 256, 16),
          _batch("dense", 999, 32)]
    want = (32 * 256 + 100 * 256 + 16 * 256 + 40 * 256) / 48
    assert spec.reader(READER).read(_run(bs)) == pytest.approx(want)
    assert spec.reader(READER).read(_run(bs[2:])) is None


def test_reveal_rows_reader_without_the_counter(monkeypatch):
    """The parent's program: its records carry no ``reveal_rows`` (its
    counters stop at ``loop_ns``), or no stamps at all."""
    monkeypatch.setattr(ps, "clock_offset_ns", lambda: 0)
    bs = [_batch("bandit", 5000, 32)]
    monkeypatch.setattr(spans, "COUNTERS", spans.COUNTERS[:-1])
    assert spec.reader(READER).read(_run(bs)) is None
    monkeypatch.undo()
    old = types.SimpleNamespace(flavor="bandit", n_real=32, stamps=None)
    assert spec.reader(READER).read(_run([old])) is None


def _page_run(fault=None, seconds=2.0):
    cell = shrink(spec.cell(CELL))
    cell.config.update(doc_tokens=45, min_doc_tokens=45)
    return bench.serve_window(cell, SEED, seconds, False,
                              torch.device("cpu"), time.perf_counter(),
                              fault=fault)


def test_page_run_is_correct():
    run = _page_run()
    assert run.inputs.corpus.mask.all()
    assert run.inputs.pool.queries.shape[1:] == (64, 128)
    out = _correct(run)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    rows = [b.counter("reveal_rows") for b in run.batches]
    assert rows and min(rows) >= 32 * 256


def test_page_run_with_a_wrong_top5_is_not_correct(monkeypatch):
    monkeypatch.setattr(bench, "ANSWER_GRACE_S", 3.0)
    out = _correct(_page_run(topk_wrong))
    assert not out["correct"], out["checks"]
    assert out["checks"]["overlap_deficit"]["value"] > \
        out["checks"]["overlap_deficit"]["limit"], out["checks"]
