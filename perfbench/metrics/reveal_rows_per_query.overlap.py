"""reveal_rows_per_query.overlap (rows, program_counter; layer: pooled
bandit): the frontier rows the pooled bandit's reveal launches staged, a
query: sum(reveal_rows) / sum(n_real) over the window's bandit batches
clear of the profiler (``BatchRecord.counter``, counted in
``core/frontier.py::run_loop``: the init launch's Q*N rows and each trip's
launch rows). Each row stages its candidate's whole doc, so at page widths
a row is 729 x 128 x 4 B. Moves overlap_at_5. None where the program
counts no ``reveal_rows``."""
from perfbench.harness import program_spans as ps


def read(run):
    try:
        from repro_torch.spans import COUNTERS
    except ImportError:
        return None
    if "reveal_rows" not in COUNTERS:
        return None
    bs = [b for b in ps.clear(run, ps.recorded(run)) if b.flavor == "bandit"]
    rows = sum(b.counter("reveal_rows") for b in bs)
    queries = sum(b.n_real for b in bs)
    if rows <= 0 or queries <= 0:
        return None
    return rows / queries
