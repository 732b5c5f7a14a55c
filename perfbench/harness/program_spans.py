"""The program's own spans, counters and collector pauses, as the per-layer
readers take them.

``repro_torch`` keeps each batch's spans on its ``BatchRecord`` (``span``,
``counter``; ``repro_torch.spans``) and collector pauses in
``repro_torch.spans.GC_EVENTS``, all stamped with ``time.time_ns()``: the
clock of the device trace (``trace.now_ns``). The run's window is kept in
``perf_counter`` seconds and is moved to that clock with an offset read
here. A program that records none of these gives nothing: each reader
then returns None.
"""
from __future__ import annotations

import time
from typing import Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[int, int]


def clock_offset_ns() -> int:
    """``time.time_ns()`` less ``time.perf_counter_ns()``, read now."""
    return time.time_ns() - time.perf_counter_ns()


def to_epoch_ns(t: float, offset: int) -> int:
    """``perf_counter`` seconds as ``time.time_ns()``."""
    return int(round(t * 1e9)) + offset


def window_ns(run) -> Interval:
    off = clock_offset_ns()
    return to_epoch_ns(run.t0, off), to_epoch_ns(run.t_end, off)


def profiled_ns(run) -> Optional[Interval]:
    """When the profiler was on: from the trace's anchor to the close of
    its read (``run.trace.on`` .. ``t1``), widened to the profiler's start
    and stop (``run.profiled``) when those are known. None in an untraced
    run."""
    if run.trace is None:
        return None
    lo, hi = run.trace.on, run.trace.t1
    if run.profiled is not None:
        off = clock_offset_ns()
        lo = min(lo, to_epoch_ns(run.profiled[0], off))
        hi = max(hi, to_epoch_ns(run.profiled[1], off))
    return lo, hi


def recorded(run) -> list:
    """The window's batch records that carry the program's spans."""
    return [b for b in run.batches if getattr(b, "stamps", None) is not None]


def extent(b) -> Optional[Interval]:
    """First start to last end of a batch's recorded spans."""
    sps = b.all_spans()
    if not sps:
        return None
    return min(sp.start for sp in sps), max(sp.end for sp in sps)


def clear(run, batches: Sequence) -> list:
    """The batches that ran inside the window and not while the profiler
    was on."""
    lo, hi = window_ns(run)
    prof = profiled_ns(run)
    out = []
    for b in batches:
        ext = extent(b)
        if ext is None or ext[0] < lo or ext[1] > hi:
            continue
        if prof is not None and ext[0] < prof[1] and ext[1] > prof[0]:
            continue
        out.append(b)
    return out


def mean_span_ms(run, name: str) -> Optional[float]:
    """Mean length of span ``name`` over the window's batches clear of the
    profiler."""
    lens = [sp[2] - sp[1] for b in clear(run, recorded(run))
            if (sp := b.span(name)) is not None]
    return sum(lens) / len(lens) / 1e6 if lens else None


def trip_sums(run) -> Optional[Tuple[int, int, int]]:
    """(trips, loop ns, wait ns) summed over the window's bandit batches
    clear of the profiler; None where no trip was counted."""
    bs = [b for b in clear(run, recorded(run)) if b.flavor == "bandit"]
    trips = sum(b.counter("trips") for b in bs)
    if trips <= 0:
        return None
    return (trips, sum(b.counter("loop_ns") for b in bs),
            sum(b.counter("wait_ns") for b in bs))


def gc_events() -> Optional[list]:
    """The program's collector pauses (generation, thread, start, end), or
    None where the program records none."""
    try:
        from repro_torch.spans import GC_EVENTS
    except ImportError:
        return None
    return list(GC_EVENTS)


# -- interval arithmetic --------------------------------------------------------

def merged(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The parts of [lo, hi] outside the merged intervals ``busy``."""
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def overlap_ns(a: Sequence[Interval], b: Sequence[Interval]) -> int:
    """Length of the intersection of two merged, sorted interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
