"""gc_pause_pct.qps (%, program_span; layer: process runtime): 100 x the
collector's pause time in the window (the engine's ``gc.callbacks`` hook,
``repro_torch.spans.GC_EVENTS``), over the window's time, both without
the profiler's on-period. Moves qps."""
from perfbench.harness import program_spans as ps


def read(run):
    events = ps.gc_events()
    if events is None:
        return None
    lo, hi = ps.window_ns(run)
    prof = ps.profiled_ns(run)
    out = [] if prof is None else [prof]
    window = hi - lo - ps.overlap_ns([(lo, hi)], out)
    if window <= 0:
        return None
    paused = sum(min(e, hi) - max(s, lo) for _, _, s, e in events
                 if s < hi and e > lo
                 and (prof is None or e <= prof[0] or s >= prof[1]))
    return 100.0 * paused / window
