"""Trigger fixture for the lockset pass: ``_count`` is written by both
the caller and worker groups with no GUARDED_BY entry and no lock;
``_state`` escapes its declared guard in ``worker_loop``."""
import threading

THREAD_ENTRY_POINTS = {
    "caller": ("submit",),
    "worker": ("worker_loop",),
}
GUARDED_BY = {
    "_state": "_lock",
}


class Racy:
    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0
        self._state = "idle"

    def submit(self, item):
        self._count += 1                               # lockset (shared)
        with self._lock:
            self._state = "queued"

    def worker_loop(self):
        self._count -= 1                               # lockset (shared)
        self._state = "serving"                        # lockset (guard escape)
