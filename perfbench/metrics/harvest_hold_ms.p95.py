"""harvest_hold_ms.p95 (ms, program_span; layer: engine): mean ``held``
span (a step returned to its harvest begun: with ``pipeline_depth`` 2 a
finished bandit batch waits there for the next batch's trip loop) over
the window's batches that ran clear of the profiler. Moves p95_ms."""
from perfbench.harness import program_spans as ps


def read(run):
    return ps.mean_span_ms(run, "held")
