"""Self-healing serving: thread supervision and graceful fidelity
degradation (port of ``repro.serve.resilience``).

* :class:`Supervisor` - a watchdog thread that notices dead pipeline
  threads of ``serve.engine.AsyncRetrievalEngine`` (killed by a fault, a
  chaos plan or a real bug), restarts them up to a budget, and escalates
  to a loud engine-wide failure when the budget is spent. Restarting is
  safe because the engine keeps every piece of in-flight state on the
  engine object, not on thread stacks, and delivers completions
  idempotently (rid-deduplicated).
* :class:`DegradeLadder` - the deadline-aware fidelity policy behind
  ``EngineConfig(backpressure="degrade")``.

The fault-injection primitives (``FaultPlan``, ``ChaosClock``,
``poison_corpus``, ...) live in :mod:`repro_torch.dist.fault` and are
re-exported here.

When a batch's tightest deadline headroom shrinks below the configured
thresholds, a serving engine moves down the ladder's rungs:

  level 0  full fidelity (no-op knobs)
  level 1  scale the effective ``alpha_ef`` (alpha_scale 2)
  level 2  scale it further AND cap the reveal rounds at 8
  level 3  maximal alpha + the tightest round cap, 4

The rungs and their knobs are the JAX package's. Its docstring says a
larger ``alpha_ef`` separates earlier; the Serfling radius grows with it,
so on its own (level 1) it separates later and may reveal more. The
round caps are what bound the work of levels 2 and 3.

The knobs are the per-call ``alpha_scale`` / ``round_cap`` of the bandit
serving steps (``retrieval.service``): a Python number or a 0-d tensor,
so changing rungs changes no shape, and level 0 is bit-identical to a
knob-less call.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional, Tuple

from repro_torch.dist.fault import (ChaosClock, ChaosKill, FaultPlan,
                                    InjectedFault, poison_corpus)

__all__ = ["ChaosClock", "ChaosKill", "DegradeLadder", "FaultPlan",
           "InjectedFault", "Supervisor", "poison_corpus"]


@dataclasses.dataclass(frozen=True)
class DegradeLadder:
    """Headroom-ratio -> (alpha_scale, round_cap) fidelity policy.

    ``headrooms`` are strictly-decreasing thresholds on the batch's
    tightest deadline-headroom ratio r = (deadline - now) / expected
    service time. ``r >= headrooms[0]`` is level 0 (full fidelity);
    crossing below ``headrooms[i]`` selects level i+1 with knobs
    ``alpha_scales[i]`` / ``round_caps[i]`` (a cap of 0 leaves the round
    budget alone). Values are per batch."""

    headrooms: Tuple[float, ...] = (1.0, 0.5, 0.25)
    alpha_scales: Tuple[float, ...] = (2.0, 4.0, 8.0)
    round_caps: Tuple[int, ...] = (0, 8, 4)

    def __post_init__(self):
        if not (len(self.headrooms) == len(self.alpha_scales)
                == len(self.round_caps)):
            raise ValueError("ladder fields must have equal length")
        if any(h2 >= h1 for h1, h2 in zip(self.headrooms,
                                          self.headrooms[1:])):
            raise ValueError("headroom thresholds must strictly decrease")
        if any(s < 1.0 for s in self.alpha_scales):
            raise ValueError("alpha_scales must be >= 1 (degrade, never "
                             "silently upgrade fidelity)")

    @property
    def n_levels(self) -> int:
        return len(self.headrooms) + 1

    def level_for(self, headroom_ratio: float) -> int:
        """0 = comfortable, len(headrooms) = maximally squeezed."""
        level = 0
        for h in self.headrooms:
            if headroom_ratio >= h:
                break
            level += 1
        return level

    def knobs(self, level: int) -> Tuple[float, int]:
        """(alpha_scale, round_cap) for a level; level 0 => (1.0, 0),
        which is bit-identical to no knobs at all."""
        if level <= 0:
            return 1.0, 0
        i = min(level, len(self.headrooms)) - 1
        return float(self.alpha_scales[i]), int(self.round_caps[i])


class Supervisor:
    """Restart-with-budget watchdog over named pipeline threads.

    The engine registers each serving thread with a factory that builds a
    STARTED replacement; the watchdog polls thread liveness every
    ``interval_s`` and, when a thread is dead while the engine is not
    stopping, either restarts it (budget remaining) or calls
    ``on_exhausted(name, last_exc)`` exactly once and stops watching.

    ``note_failure`` records the exception a dying thread saw so the
    escalation path can chain it. All mutation happens under one lock;
    the watchdog itself is a daemon thread and is joined on ``stop()``.
    """

    def __init__(self, *, max_restarts: int = 2, interval_s: float = 0.02,
                 stopping: Callable[[], bool] = lambda: False,
                 on_exhausted: Optional[
                     Callable[[str, Optional[BaseException]], None]] = None):
        if max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        self._max_restarts = int(max_restarts)
        self._interval = float(interval_s)
        self._stopping = stopping
        self._on_exhausted = on_exhausted
        self._lock = threading.Lock()
        self._threads: Dict[str, threading.Thread] = {}
        self._factories: Dict[str, Callable[[], threading.Thread]] = {}
        self._on_restart: Dict[str, Optional[Callable[[], None]]] = {}
        self._last_exc: Dict[str, BaseException] = {}
        self._gave_up: set = set()
        self.restarts: Dict[str, int] = {}
        self._stop_evt = threading.Event()
        self._watchdog: Optional[threading.Thread] = None

    def watch(self, name: str, thread: threading.Thread,
              factory: Callable[[], threading.Thread],
              on_restart: Optional[Callable[[], None]] = None) -> None:
        with self._lock:
            self._threads[name] = thread
            self._factories[name] = factory
            self._on_restart[name] = on_restart
            self.restarts.setdefault(name, 0)

    def note_failure(self, name: str, exc: BaseException) -> None:
        """Called by a dying thread's guard so escalation can chain the
        original exception instead of reporting a bare dead thread."""
        with self._lock:
            self._last_exc[name] = exc

    def start(self) -> "Supervisor":
        if self._watchdog is not None:
            return self
        self._stop_evt.clear()
        self._watchdog = threading.Thread(
            target=self._loop, name="repro-supervisor", daemon=True)
        self._watchdog.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        w, self._watchdog = self._watchdog, None
        if w is not None:
            w.join(timeout=10.0)

    def _loop(self) -> None:
        while not self._stop_evt.wait(self._interval):
            if self._stopping():
                continue            # normal shutdown: dead threads are fine
            with self._lock:
                dead = [(n, t) for n, t in self._threads.items()
                        if not t.is_alive() and n not in self._gave_up]
            for name, _ in dead:
                if self._stopping() or self._stop_evt.is_set():
                    return
                with self._lock:
                    exhausted = self.restarts[name] >= self._max_restarts
                    if not exhausted:
                        self.restarts[name] += 1
                    exc = self._last_exc.get(name)
                if exhausted:
                    with self._lock:
                        self._gave_up.add(name)
                    if self._on_exhausted is not None:
                        self._on_exhausted(name, exc)
                    continue
                cb = self._on_restart.get(name)
                if cb is not None:
                    cb()
                fresh = self._factories[name]()
                with self._lock:
                    self._threads[name] = fresh
