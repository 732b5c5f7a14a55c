"""setup_s (s, host_clock): process start to the window's start: imports,
the corpus and queries made on the card, the engine built, the cell's
buckets warmed (the kernels built on a checkout's first run) and the
warm-up requests served."""


def read(run):
    return run.setup_s
