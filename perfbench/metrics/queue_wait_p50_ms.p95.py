"""queue_wait_p50_ms.p95 (ms, program_counter; layer: engine): median of
the engine's ``Completion.queue_wait_s``, admission to batch release."""
import numpy as np


def read(run):
    w = [c.queue_wait_s for c in run.completions()]
    return float(np.median(w)) * 1e3 if w else None
