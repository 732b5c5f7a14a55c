"""Fault-tolerance primitives (port of ``repro.dist.fault``; pure Python
and numpy, the same code).

* :func:`simulate_failure` - a deterministic in-process "kill" for testing
  the checkpoint/restart contract: crash at step k, restart, land bit for
  bit on an uninterrupted run's parameters (``train/trainer.py``).
* :class:`DeadlineBatcher` - the serving admission queue: release a batch
  when it is FULL or when the oldest request has waited past the deadline
  (padded to the batch shape so one warmed step serves both).
* :class:`FaultPlan` / :class:`InjectedFault` - the deterministic chaos
  harness: a replayable script of thread kills, shard health flips and
  dispatch delays, fired by counter (not wall clock) at named chaos points
  so two runs of the same plan inject the identical fault sequence.
* :class:`ChaosClock` - a thread-safe virtual clock so injected delays and
  deadline accounting stay deterministic in tests.
* :func:`poison_corpus` - seeded NaN/Inf corruption of a fraction of corpus
  rows, for exercising the finite-score quarantine guard end to end.
* :func:`reshard` - place a host tree on a ``dist.mesh.Mesh`` by a
  matching tree of placements.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.dist.mesh import place


class SimulatedFailure(RuntimeError):
    """Raised by the failure guard to emulate a worker being killed."""


def simulate_failure(run: Callable[[Callable[[int], None]], Any],
                     fail_at_step: int) -> bool:
    """Run ``run(guard)`` where ``guard(step)`` kills the run the first time
    ``step == fail_at_step``. Returns True when the failure fired (the run
    died mid-flight), False when the run finished before reaching the step.
    """
    fired = [False]

    def guard(step: int) -> None:
        if step == fail_at_step and not fired[0]:
            fired[0] = True
            raise SimulatedFailure(f"simulated failure at step {step}")

    try:
        run(guard)
    except SimulatedFailure:
        return True
    return fired[0]


class ChaosKill(RuntimeError):
    """Raised inside a serving thread by a FaultPlan ``kill`` action — the
    supervised analogue of the thread being SIGKILLed mid-loop. The engine
    watchdog recognizes it (and any other exception) as a dead thread and
    restarts within the restart budget."""


@dataclasses.dataclass(frozen=True)
class InjectedFault:
    """One scripted fault.

    ``point`` names the chaos point ("admit" | "dispatch" | "stream" —
    the engine ticks its point once per thread-loop iteration), ``at`` is
    the tick count at which the fault fires (the Nth time that point is
    reached), ``action`` is what happens:

    * ``"kill"``       — raise :class:`ChaosKill` in the ticking thread,
    * ``"shard_down"`` — mark mesh shard ``int(arg)`` unhealthy,
    * ``"shard_up"``   — restore mesh shard ``int(arg)``,
    * ``"delay"``      — stall the ticking thread ``arg`` seconds (advanced
      on a :class:`ChaosClock` when the engine clock is one, else slept).
    """

    point: str
    at: int
    action: str
    arg: float = 0.0

    def __post_init__(self):
        if self.action not in ("kill", "shard_down", "shard_up", "delay"):
            raise ValueError(f"unknown fault action {self.action!r}")
        if self.at < 1:
            raise ValueError("fault fires at tick >= 1")


class FaultPlan:
    """A deterministic, replayable fault schedule.

    Counter-based, not clock-based: every serving-thread loop iteration
    ticks its named chaos point, and a fault fires when its point's counter
    reaches ``at``. Two runs of the same plan over the same request stream
    therefore inject the identical fault sequence at the identical loop
    boundaries — the property the chaos soak's replay assertions need.
    An EMPTY plan is inert by construction (``tick`` returns nothing and
    the engine skips the chaos hook entirely), so a no-fault run is
    bit-identical to a run without a plan.

    Thread-safe: chaos points tick from the serving threads while tests
    read ``fired`` from the caller thread.
    """

    def __init__(self, faults: Sequence[InjectedFault] = ()):
        self.faults = tuple(faults)
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._fired: List[InjectedFault] = []
        self._by_point: Dict[str, Dict[int, List[InjectedFault]]] = {}
        for f in self.faults:
            self._by_point.setdefault(f.point, {}).setdefault(
                f.at, []).append(f)

    @classmethod
    def seeded(cls, seed: int, *, points: Sequence[str] = ("dispatch",),
               n_faults: int = 1, max_tick: int = 50,
               actions: Sequence[str] = ("kill",),
               shards: Sequence[int] = (0,),
               delay_s: float = 0.0) -> "FaultPlan":
        """A randomized-but-replayable plan: ``n_faults`` faults drawn with
        ``numpy.random.default_rng(seed)`` over the given points, tick
        range and actions. The same seed always yields the same plan."""
        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(n_faults):
            action = actions[int(rng.integers(len(actions)))]
            arg = 0.0
            if action in ("shard_down", "shard_up"):
                arg = float(shards[int(rng.integers(len(shards)))])
            elif action == "delay":
                arg = delay_s
            faults.append(InjectedFault(
                point=points[int(rng.integers(len(points)))],
                at=int(rng.integers(1, max_tick + 1)),
                action=action, arg=arg))
        return cls(faults)

    @property
    def empty(self) -> bool:
        return not self.faults

    def tick(self, point: str) -> List[InjectedFault]:
        """Advance ``point``'s counter; return the faults firing at this
        tick (kills last, so a kill+state-flip tick applies the flip)."""
        if not self.faults:
            return []
        with self._lock:
            c = self._counts.get(point, 0) + 1
            self._counts[point] = c
            due = list(self._by_point.get(point, {}).get(c, []))
            self._fired.extend(due)
        return sorted(due, key=lambda f: f.action == "kill")

    @property
    def fired(self) -> List[InjectedFault]:
        """Snapshot of the faults that have fired so far (test surface)."""
        with self._lock:
            return list(self._fired)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


class ChaosClock:
    """A thread-safe virtual clock: ``()`` reads the time, ``advance``
    moves it, ``sleep`` is an advance (injected delays cost virtual time
    only). Inject as the engine's ``clock=`` so deadline accounting and
    FaultPlan delays are deterministic and wall-time-free in tests."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            return self._t

    def advance(self, dt: float) -> None:
        with self._lock:
            self._t += float(dt)

    def sleep(self, dt: float) -> None:
        self.advance(dt)


def apply_delay(clock: Callable[[], float], seconds: float) -> None:
    """Stall the calling thread ``seconds``: virtually when ``clock`` is a
    :class:`ChaosClock`, else a real ``time.sleep`` — the one place the
    chaos harness decides between simulated and wall time."""
    if seconds <= 0:
        return
    if isinstance(clock, ChaosClock):
        clock.sleep(seconds)
    else:
        time.sleep(seconds)


def poison_corpus(embs, fraction: float, seed: int = 0, *,
                  mode: str = "nan") -> Tuple[np.ndarray, np.ndarray]:
    """Seeded corruption of a fraction of corpus doc rows.

    Returns ``(poisoned_embs, poisoned_mask)`` where ``poisoned_mask`` is
    the (C,) bool row selection — at least one row whenever ``fraction >
    0`` and the corpus is non-empty. ``mode`` is ``"nan"`` | ``"inf"`` |
    ``"neginf"``; the corruption hits every token of the selected docs so
    any reveal of the row trips the finite-score guard. The input is
    copied, never mutated."""
    embs = np.array(embs, dtype=np.float32, copy=True)
    C = embs.shape[0]
    mask = np.zeros((C,), bool)
    n_bad = int(round(C * float(fraction)))
    if fraction > 0 and C:
        n_bad = max(n_bad, 1)
    if n_bad:
        rng = np.random.default_rng(seed)
        rows = rng.choice(C, size=min(n_bad, C), replace=False)
        val = {"nan": np.nan, "inf": np.inf, "neginf": -np.inf}
        try:
            embs[rows] = val[mode]
        except KeyError:
            raise ValueError(f"unknown poison mode {mode!r} "
                             "(expected 'nan', 'inf' or 'neginf')") from None
        mask[rows] = True
    return embs, mask


class DeadlineBatcher:
    """Admission batching with a latency deadline.

    ``add`` enqueues a request; ``poll`` returns ``None`` while the batch is
    neither full nor expired, otherwise ``(requests, n_real)`` where
    ``requests`` always has exactly ``batch_size`` entries (short batches
    are padded by repeating the last real request, so the jitted serving
    step sees one static shape) and ``n_real`` counts the genuine ones.
    The deadline clock starts at the OLDEST pending request, so a trickle
    of traffic is released within ``deadline_s`` of its first arrival.

    A request may carry its own (tighter) admission deadline, two ways:

    * ``add(req, deadline_s=...)`` — a relative admission deadline, frozen
      at add time: release once the request has waited that long.
    * ``add(req, deadline_abs=...)`` — an absolute COMPLETION deadline
      (clock frame). The admission deadline is derived lazily, at every
      ``next_expiry``/``poll``, as ``deadline_abs - headroom()`` where
      ``headroom`` is the constructor-supplied callable (e.g. the serving
      engine's live batch-service-time EMA). Deriving at poll time — not
      at add time — is what keeps queued requests honest when the service
      estimate RISES while they wait: a frozen admission deadline would
      release them too late to execute before completion is due.

    The batch releases as soon as ANY pending request is past its
    (tightest) admission deadline, so a latency-critical request is never
    held behind the global window. ``next_expiry`` returns the CURRENT
    clock when a full batch is already pending: a caller sleeping until
    ``next_expiry()`` must wake immediately, since ``poll`` would release
    right now (sleeping through a ready full batch was a real bug).

    All queue operations take an internal lock, so producers (``add``) and
    a consumer loop (``next_expiry``/``poll``/``flush``) may live on
    different threads — the async serving engine's contract.
    """

    def __init__(self, batch_size: int, deadline_s: float,
                 clock: Callable[[], float] = time.monotonic,
                 headroom: Optional[Callable[[], float]] = None):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.batch_size = int(batch_size)
        self.deadline_s = float(deadline_s)
        self.clock = clock
        self.headroom = headroom or (lambda: 0.0)
        self._lock = threading.Lock()
        # (arrival_ts, admission_deadline_s|None, deadline_abs|None, req)
        self._pending: deque = deque()

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)

    def add(self, request: Any, deadline_s: Optional[float] = None,
            deadline_abs: Optional[float] = None) -> None:
        entry = (self.clock(), deadline_s, deadline_abs, request)
        with self._lock:
            self._pending.append(entry)

    def _entry_expiry(self, ts: float, d: Optional[float],
                      d_abs: Optional[float], headroom: float) -> float:
        """Absolute admission deadline of one entry: the global window,
        tightened by a frozen relative deadline and/or a live-derived
        absolute one. Clamped to the arrival stamp so a request already
        past ``deadline_abs - headroom`` releases immediately instead of
        producing an expiry in the past."""
        expiry = ts + self.deadline_s
        if d is not None:
            expiry = min(expiry, ts + d)
        if d_abs is not None:
            expiry = min(expiry, max(ts, d_abs - headroom))
        return expiry

    def next_expiry(self) -> Optional[float]:
        """Earliest absolute time at which ``poll`` will release a batch
        (None when the queue is empty). A ready FULL batch expires NOW —
        the caller's poll loop must not sleep through it."""
        with self._lock:
            return self._next_expiry_locked()

    def _next_expiry_locked(self) -> Optional[float]:
        if not self._pending:
            return None
        if len(self._pending) >= self.batch_size:
            return self.clock()
        headroom = self.headroom()
        return min(self._entry_expiry(ts, d, d_abs, headroom)
                   for ts, d, d_abs, _ in self._pending)

    def poll(self) -> Optional[Tuple[List[Any], int]]:
        with self._lock:
            if not self._pending:
                return None
            if len(self._pending) >= self.batch_size:
                reqs = [self._pending.popleft()[3]
                        for _ in range(self.batch_size)]
                return reqs, self.batch_size
            if self.clock() < self._next_expiry_locked():
                return None
            return self._flush_locked()

    def flush(self) -> Optional[Tuple[List[Any], int]]:
        """Release the oldest pending batch immediately (padded), deadline
        or not. At most ``batch_size`` real requests per call — the padded
        static-shape contract holds even when more are pending; call in a
        loop (or ``poll`` first) to drain completely."""
        with self._lock:
            return self._flush_locked()

    def _flush_locked(self) -> Optional[Tuple[List[Any], int]]:
        if not self._pending:
            return None
        take = min(len(self._pending), self.batch_size)
        reqs = [self._pending.popleft()[3] for _ in range(take)]
        n_real = len(reqs)
        reqs = reqs + [reqs[-1]] * (self.batch_size - n_real)
        return reqs, n_real


def reshard(tree: Any, specs: Any, mesh) -> Any:
    """Place every leaf of ``tree`` on ``mesh`` by its placement in
    ``specs``, a matching tree (dicts, lists and tuples) whose leaves are
    the split dim or ``None`` for a leaf every shard holds whole. Leaves
    are numpy-convertible or tensors; each becomes a
    ``dist.mesh.Sharded``. A host tree can so land in a new layout."""
    def go(x, s):
        if isinstance(x, dict):
            if set(x) != set(s):
                raise ValueError(f"tree keys {sorted(x)} != spec keys "
                                 f"{sorted(s)}")
            return type(x)((k, go(x[k], s[k])) for k in x)
        if isinstance(x, (list, tuple)):
            if len(x) != len(s):
                raise ValueError(f"tree of {len(x)} leaves, specs of "
                                 f"{len(s)}")
            out = [go(a, b) for a, b in zip(x, s)]
            return type(x)(*out) if hasattr(x, "_fields") else type(x)(out)
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        return place(t, mesh, s)

    return go(tree, specs)
