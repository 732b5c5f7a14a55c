"""admit_ms_per_batch.qps (ms, program_span; layer: engine): mean ``admit``
span (the admit thread's work on a released batch: bucketing, padding,
stage 1, the host-to-device copies of its operands) over the window's
batches that ran clear of the profiler. Moves qps."""
from perfbench.harness import program_spans as ps


def read(run):
    return ps.mean_span_ms(run, "admit")
