"""p95_ms (ms, host_clock): 95th percentile of every request's latency in
the window, each timed from its intended send time; a failed request
counts as infinite."""


def read(run):
    return run.latency_quantile_ms(0.95)
