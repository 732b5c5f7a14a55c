"""qps (req/s, host_clock): requests answered without error inside the
window, over the window's seconds (the client's clock)."""


def read(run):
    return len(run.completed_in_window()) / run.seconds
