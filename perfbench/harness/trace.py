"""The device trace of a short steady sub-window, and what is read from it.

``profile_window`` runs ``torch.profiler`` with CPU and CUDA activity
from ``start`` for ``seconds`` (a whole window of host-bound bandit trips
makes about 10^6 device records, and long profiles lose records) while
the traffic runs on another thread; ``reduce`` reads it once the window
has closed. Device records carry the host's epoch clock, as do the host
spans the benchmark records around the engine's stage-1, step and harvest
calls (``HostSpans``), so the two are read on one time line; an anchor
range taken as the profile opens gives the offset between them.

Only device activity is traced (kernels, copies, and their launches on the
host), not the host's operators, which would double the records. Each
kernel record is tied to its launch on the host by the profiler's
correlation id, which gives the host time of the launch (so the step that
launched it) and the launches whose device record was lost. A spin kernel
launched as the profile opens checks the profiler's clock against the
host's.
"""
from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# The anchor's kernel (torch.cuda._sleep), and host-side records the
# profiler files under the device: neither is the program's device work.
ANCHOR = "spin_kernel"
NOT_DEVICE_WORK = ("Command Buffer Full", ANCHOR)


def now_ns() -> int:
    return time.time_ns()


Span = Tuple[str, int, int, int, int, tuple]


class HostSpans:
    """Spans of named engine calls: (name, native thread id, start ns, end
    ns, queries, request ids); ``wrap`` puts a recorder around an engine
    method, ``rids`` reads the request ids from its arguments."""

    def __init__(self):
        self.spans: List[Span] = []

    def wrap(self, obj, attr: str, name: str, count_arg: Optional[int] = None,
             rids: Optional[Callable[..., Sequence[int]]] = None):
        fn = getattr(obj, attr)

        def recorded(*args, **kwargs):
            t0 = now_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                n = len(args[count_arg]) if count_arg is not None else 0
                ids = tuple(rids(*args)) if rids is not None else ()
                self.spans.append((name, threading.get_native_id(), t0,
                                   now_ns(), n, ids))

        setattr(obj, attr, recorded)


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int           # ns, host epoch clock
    end: int
    launched: Optional[int] = None   # ns, when the host launched it


@dataclasses.dataclass
class Trace:
    t0: int              # the sub-window read for busy and idle time
    t1: int
    ops: List[DeviceOp]
    spans: List[Span]
    on: int = 0          # when the profile opened
    launches: int = 0    # kernel launches the profile saw on the host
    lost: Optional[List[int]] = None  # host times of launches whose
    #                                    kernel record is missing (None: no
    #                                    record tied to a launch)
    start_s: float = 0.0  # how long switching the profiler on took
    stop_s: float = 0.0   # and switching it off
    _named: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def _clipped(self):
        for op in self.ops:
            s, e = max(op.start, self.t0), min(op.end, self.t1)
            if e > s:
                yield op, s, e

    def busy(self) -> List[Tuple[int, int]]:
        """Merged intervals in which some operation ran on the device."""
        out: List[List[int]] = []
        for _, s, e in sorted(self._clipped(), key=lambda x: x[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def top_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, int] = {}
        for op, s, e in self._clipped():
            tot[op.name] = tot.get(op.name, 0) + (e - s)
        best = sorted(tot.items(), key=lambda x: -x[1])[:n]
        return [[k[:120], v / 1e9] for k, v in best]

    def whole_steps(self, margin: int = 50_000_000) -> List[Span]:
        """The step spans that ran whole while the profile was on (ending
        ``margin`` ns before it closed) and lost no kernel record."""
        if self.lost is None:
            return []
        return [sp for sp in self.spans
                if sp[0] == "step" and sp[2] >= self.on
                and sp[3] <= self.t1 - margin
                and not any(sp[2] <= t <= sp[3] for t in self.lost)]

    def step_kernel_s(self, sp: Span, *parts: str) -> float:
        """Device seconds of the kernels named by ``parts`` that step span
        ``sp`` launched."""
        named = self._named.get(parts)
        if named is None:
            named = sorted((op.launched, op.end - op.start) for op in self.ops
                           if op.launched is not None
                           and any(p in op.name for p in parts))
            self._named[parts] = named
        lo = bisect.bisect_left(named, (sp[2], -1))
        hi = bisect.bisect_right(named, (sp[3], float("inf")))
        return sum(d for _, d in named[lo:hi]) / 1e9

    def _host_at(self, t: int) -> str:
        names = sorted({sp[0] for sp in self.spans if sp[2] <= t < sp[3]})
        return "+".join(names) or "client"

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest gaps with no device operation, each named by the
        engine calls open on the host at its middle."""
        edges = [self.t0]
        for s, e in self.busy():
            edges += [s, e]
        edges.append(self.t1)
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at((s + e) // 2), (e - s) / 1e9]
                for s, e in gaps[:n]]


# The profiler is switched on this share of the way into the window and
# read for TRACE_S seconds, from SETTLE_S after it is on. Set-up primes it
# (``prime``): switched on for the first time in a process, it held the
# serving threads for seconds. TRACE_S holds some hundreds of dense steps;
# the bandit's trips launch about 40,000 kernels a second, and a profile
# of 140,000 launches lost nearly all its device records.
TRACE_LEAD = 0.4
TRACE_S = 2.0
SETTLE_S = 0.25
# Host-side launch records of a kernel (cudaLaunchKernel, cuLaunchKernel,
# cudaLaunchKernelExC).
LAUNCH = "aunchKernel"


def prime() -> None:
    """Profile one small operation, so that the profiler's device tracing
    is loaded and set up before the window (in set-up, not in the window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def profile_window(start: float, seconds: float):
    """Profile the device from ``start`` (perf_counter seconds) for
    ``SETTLE_S + seconds``, on the calling thread (the profiler's device
    tracing must start on the thread that set it up), and read the last
    ``seconds``. Returns what ``reduce`` reads and the perf_counter times
    the profiler was on; nothing is parsed here, so the window is not held
    up."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    time.sleep(max(0.0, start - time.perf_counter()))
    on = time.perf_counter()
    prof = profile(activities=[ProfilerActivity.CUDA])
    with prof:
        started = time.perf_counter()
        anchor = now_ns()
        torch.cuda._sleep(1000)
        time.sleep(SETTLE_S)
        t0 = now_ns()
        time.sleep(seconds)
        t1 = now_ns()
        stopping = time.perf_counter()
    off = time.perf_counter()
    return ((prof, anchor, t0, t1, started - on, off - stopping),
            (on, off))


def reduce(raw, spans: HostSpans) -> Trace:
    import torch
    prof, anchor, t0, t1, start_s, stop_s = raw
    tr = _reduce(prof, anchor, t0, t1, spans, torch.autograd.DeviceType.CUDA)
    tr.start_s, tr.stop_s = start_s, stop_s
    return tr


def _reduce(prof, anchor: int, t0: int, t1: int, spans: HostSpans,
            cuda) -> Trace:
    events = prof.profiler.kineto_results.events()
    launched = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() != cuda and LAUNCH in e.name()}
    # The profiler's times are Unix ns, as the host's; the anchor, where its
    # record survived (a profile's first device records may be dropped),
    # corrects what is left between the two clocks.
    mark = next((e.correlation_id() for e in events
                 if e.device_type() == cuda and ANCHOR in e.name()
                 and e.correlation_id() in launched), None)
    offset = 0 if mark is None else launched.pop(mark) - anchor
    launched = {c: t - offset for c, t in launched.items()}
    dev = [e for e in events if e.device_type() == cuda
           and not any(x in e.name() for x in NOT_DEVICE_WORK)]
    ids = {e.correlation_id() for e in dev}
    ops = []
    for e in dev:
        s = e.start_ns() - offset
        ops.append(DeviceOp(e.name(), s, s + e.duration_ns(),
                            launched.get(e.correlation_id())))
    # A launch in the profile's last 50 ms may not have run before it closed.
    lost = (sorted(t for c, t in launched.items()
                   if c not in ids and t < t1 - 50_000_000)
            if ids & launched.keys() else None)
    return Trace(t0=t0, t1=t1, ops=ops, spans=list(spans.spans),
                 on=anchor, launches=len(launched), lost=lost)
