"""graph_trip_share.p95 (frac, program_counter; layer: pooled bandit): the
share of the pooled trip loop's trips that replayed a captured trip graph:
sum(graph_trips) / sum(trips) over the window's bandit batches clear of the
profiler (``BatchRecord.counter``, counted in
``core/frontier.py::run_loop``). Moves p95_ms. None where the program
counts no ``graph_trips`` or no trip was counted."""
from perfbench.harness import program_spans as ps


def read(run):
    try:
        from repro_torch.spans import COUNTERS
    except ImportError:
        return None
    if "graph_trips" not in COUNTERS:
        return None
    bs = [b for b in ps.clear(run, ps.recorded(run)) if b.flavor == "bandit"]
    trips = sum(b.counter("trips") for b in bs)
    if trips <= 0:
        return None
    return sum(b.counter("graph_trips") for b in bs) / trips
