"""latency_p95_ms.qps (ms, host_clock; layer: service, client view): the
95th percentile of the latency of the traced run's requests whose life
did not overlap the profiler being on, in a closed-loop cell, where the
clients' pace, not the tail, is what users feel. Moves qps."""


def read(run):
    return run.latency_quantile_ms(0.95, run.unprofiled())
