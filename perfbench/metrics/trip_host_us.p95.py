"""trip_host_us.p95 (us, program_counter; layer: pooled bandit): the
pooled trip loop's time not spent blocked in its host reads, a trip:
sum(loop_ns - wait_ns) / sum(trips) over the window's bandit batches clear
of the profiler (``BatchRecord.counter``, counted in
``core/frontier.py::run_loop``). Moves p95_ms."""
from perfbench.harness import program_spans as ps


def read(run):
    sums = ps.trip_sums(run)
    if sums is None:
        return None
    trips, loop_ns, wait_ns = sums
    return (loop_ns - wait_ns) / trips / 1e3
