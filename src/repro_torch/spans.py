"""Batch spans, trip counters and engine events on one clock.

Every stamp is ``time.time_ns()``: Unix nanoseconds, the clock the
profiler's device records carry, so a program span and a device operation
sit on one time line with no conversion. (The engine's injectable
``clock`` stays what deadlines and fake-clock tests run on; spans never
read it.)

A batch's spans and counters are one flat ``array('q')`` of
:data:`WIDTH` integers (its *stamps*), made when the batch is released
and kept on its ``BatchRecord``: no object per span, nothing for the
collector to walk. Each span takes three slots, (native thread id, start
ns, end ns); an end of 0 means the span was not recorded. The spans, with
the thread that closes each:

=========  ==========  ===================================================
span       parent      from -> to (thread)
=========  ==========  ===================================================
admit                  release -> prepared (admit thread)
stage1     admit       the engine's stage-1 call (admit thread)
upload     admit       host-to-device copies of the batch's operands
queued                 prepared -> taken by the dispatch thread (dispatch)
step                   the step call; the bandit's whole trip loop
held                   step returned -> harvest begun (the pipeline
                       hand-off; dispatch)
harvest                copy to the host and attribution (dispatch)
download   harvest     the ``.cpu()`` of the outputs: the wait on the device
deliver                futures resolved and their callbacks run
=========  ==========  ===================================================

The counters after them: ``stage1_queries`` (queries the stage-1 call
served), and from the pooled trip loop (``core/frontier.py::run_loop``,
summed over a mesh's per-shard loops) ``trips``, ``reads`` (its host reads,
the continue tests), ``wait_ns`` (time blocked in them), ``loop_ns``
(first iteration to last), ``graph_trips`` (its trips that replayed a
captured trip graph, ``core/frontier.py::TripGraph``; 0 on the eager
path) and ``reveal_rows`` (the frontier rows its reveal launches stage:
the init launch's Q*N and each trip's launch rows, counted from their
shapes).

A thread that works on a batch opens its stamps (:func:`open_batch`) so
code below the engine finds them (:func:`open_stamps`) without an
argument; nothing is recorded where none is open.

Engine events outside any batch: collector pauses (:func:`hook_gc`, one
``gc.callbacks`` hook a process, counted by its users) land in the
bounded :data:`GC_EVENTS`; builds after warmup are kept by the engine's
``EngineMetrics``.
"""
from __future__ import annotations

import array
import gc
import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional, Tuple

now_ns = time.time_ns

SPANS = ("admit", "stage1", "upload", "queued", "step", "held", "harvest",
         "download", "deliver")
PARENTS = {"stage1": "admit", "upload": "admit", "download": "harvest"}
COUNTERS = ("stage1_queries", "trips", "reads", "wait_ns", "loop_ns",
            "graph_trips", "reveal_rows")

# Slot offsets (a span's thread id; its start and end follow).
(ADMIT, STAGE1, UPLOAD, QUEUED, STEP, HELD, HARVEST, DOWNLOAD,
 DELIVER) = range(0, 3 * len(SPANS), 3)
(STAGE1_QUERIES, TRIPS, READS, WAIT_NS, LOOP_NS, GRAPH_TRIPS,
 REVEAL_ROWS) = range(3 * len(SPANS), 3 * len(SPANS) + len(COUNTERS))
WIDTH = 3 * len(SPANS) + len(COUNTERS)
_ZEROS = array.array("q", bytes(8 * WIDTH))


class Span(NamedTuple):
    name: str
    tid: int          # native thread id of the thread that closed it
    start: int        # ns, time.time_ns()
    end: int
    parent: Optional[str]


def new() -> array.array:
    """A batch's stamps, all zero (nothing recorded)."""
    return array.array("q", _ZEROS)


class _Local(threading.local):
    stamps: Optional[array.array] = None   # the thread's open batch
    tid = 0                                # its native id, once read


_local = _Local()


def _tid() -> int:
    t = _local.tid
    if not t:
        t = _local.tid = threading.get_native_id()
    return t


def begin(st: array.array, at: int) -> None:
    st[at + 1] = now_ns()


def end(st: array.array, at: int) -> None:
    """Close a span on the calling thread (its thread id is this one)."""
    st[at] = _tid()
    st[at + 2] = now_ns()


def instant(st: array.array, at: int, t: int) -> None:
    """A span of zero length at ``t`` on the calling thread."""
    st[at] = _tid()
    st[at + 1] = st[at + 2] = t


def open_stamps() -> Optional[array.array]:
    """The stamps of the batch the calling thread works on, if any."""
    return _local.stamps


def open_batch(st: Optional[array.array]) -> Optional[array.array]:
    """Make ``st`` the calling thread's open stamps; returns the ones it
    replaces, for the caller to restore."""
    prev = _local.stamps
    _local.stamps = st
    return prev


def span(st: array.array, name: str) -> Optional[Tuple[int, int, int]]:
    """(thread id, start, end) of span ``name``, None if not recorded."""
    at = 3 * SPANS.index(name)
    return (st[at], st[at + 1], st[at + 2]) if st[at + 2] else None


def spans(st: array.array) -> List[Span]:
    """The recorded spans, in :data:`SPANS` order."""
    return [Span(n, st[3 * i], st[3 * i + 1], st[3 * i + 2], PARENTS.get(n))
            for i, n in enumerate(SPANS) if st[3 * i + 2]]


def counter(st: array.array, name: str) -> int:
    return st[3 * len(SPANS) + COUNTERS.index(name)]


# -- collector pauses ---------------------------------------------------------

# (generation, native thread id, start ns, end ns) of the latest pauses,
# kept after the hook is removed so a reader can take them after a run.
GC_EVENTS: deque = deque(maxlen=1 << 16)
_gc_lock = threading.Lock()
_gc_users = 0
_gc_t0 = 0


def _on_gc(phase: str, info: dict) -> None:
    # The collector runs one collection at a time, so one start suffices.
    global _gc_t0
    if phase == "start":
        _gc_t0 = now_ns()
    elif _gc_t0:
        GC_EVENTS.append((info["generation"], _tid(), _gc_t0, now_ns()))
        _gc_t0 = 0


def hook_gc() -> None:
    """Record collector pauses from now on (once a process, however many
    callers hook it)."""
    global _gc_users
    with _gc_lock:
        _gc_users += 1
        if _gc_users == 1:
            gc.callbacks.append(_on_gc)


def unhook_gc() -> None:
    """Undo one :func:`hook_gc`; the last one removes the hook."""
    global _gc_users
    with _gc_lock:
        if _gc_users == 0:
            return
        _gc_users -= 1
        if _gc_users == 0 and _on_gc in gc.callbacks:
            gc.callbacks.remove(_on_gc)
