"""trip_wait_us.p95 (us, program_counter; layer: pooled bandit): time the
pooled trip loop spent blocked in its host reads (each trip's continue
test waits for the device), a trip: sum(wait_ns) / sum(trips) over the
window's bandit batches clear of the profiler. Moves p95_ms."""
from perfbench.harness import program_spans as ps


def read(run):
    sums = ps.trip_sums(run)
    if sums is None:
        return None
    trips, _, wait_ns = sums
    return wait_ns / trips / 1e3
