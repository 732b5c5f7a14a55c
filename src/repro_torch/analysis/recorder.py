"""Run-time thread-access sanitizer: the dynamic twin of the static
lockset pass (:mod:`repro_torch.analysis.locks`; the port's copy of
``repro.analysis.recorder``).

:class:`ThreadAccessRecorder` instruments a live object (the serving
engine) by swapping in a dynamically built subclass whose
``__getattribute__`` / ``__setattr__`` record which THREADS touch which
instance attributes. After a run, ``violations()`` returns every
attribute that was written and touched by >= 2 threads without a declared
guard: the static pass's failure condition, measured instead of derived.

Debug only: the instrumentation costs a dict update per attribute access
and is installed and removed explicitly (or by ``with``)::

    with ThreadAccessRecorder(engine, declared=set(GUARDED_BY)) as rec:
        ... serve traffic ...
    assert rec.violations() == []
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Set


class ThreadAccessRecorder:
    def __init__(self, obj, *, declared: Iterable[str] = ()):
        self._obj = obj
        self._orig_cls = type(obj)
        self._declared = set(declared)
        self._lock = threading.Lock()
        self.reads: Dict[str, Set[str]] = {}
        self.writes: Dict[str, Set[str]] = {}
        rec = self

        class _Instrumented(self._orig_cls):  # type: ignore[misc]
            def __getattribute__(s, name):
                if name in object.__getattribute__(s, "__dict__"):
                    rec._note(rec.reads, name)
                return object.__getattribute__(s, name)

            def __setattr__(s, name, value):
                rec._note(rec.writes, name)
                object.__setattr__(s, name, value)

        _Instrumented.__name__ = f"Recorded{self._orig_cls.__name__}"
        self._instr_cls = _Instrumented

    def _note(self, table: Dict[str, Set[str]], name: str) -> None:
        thread = threading.current_thread().name
        with self._lock:
            table.setdefault(name, set()).add(thread)

    def install(self) -> "ThreadAccessRecorder":
        self._obj.__class__ = self._instr_cls
        return self

    def uninstall(self) -> None:
        self._obj.__class__ = self._orig_cls

    __enter__ = install

    def __exit__(self, exc_type, exc, tb) -> None:
        self.uninstall()

    def shared(self) -> Dict[str, Dict[str, Set[str]]]:
        """attr -> {"read": threads, "write": threads} for every attr
        touched by >= 2 distinct threads."""
        with self._lock:
            out = {}
            for attr in set(self.reads) | set(self.writes):
                threads = (self.reads.get(attr, set())
                           | self.writes.get(attr, set()))
                if len(threads) >= 2:
                    out[attr] = {
                        "read": set(self.reads.get(attr, set())),
                        "write": set(self.writes.get(attr, set()))}
            return out

    def violations(self) -> List[str]:
        """Attributes written and touched by >= 2 threads that are not in
        the declared guard set — the measured analogue of the static
        lockset rule. (Attributes whose only writes predate install —
        init-time state — never show a writer thread and pass.)"""
        out = []
        for attr, acc in sorted(self.shared().items()):
            if attr in self._declared or not acc["write"]:
                continue
            out.append(f"{attr}: written by {sorted(acc['write'])}, "
                       f"read by {sorted(acc['read'])}, no declared guard")
        return out
