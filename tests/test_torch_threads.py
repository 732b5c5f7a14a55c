"""Torch's intra-op threads in the port's CPU tests.

Under pytest-xdist several workers share one machine, and each worker's
torch would start one intra-op thread per core: workers x cores threads
fight for the cores. Every other ``tests/test_torch_*.py`` calls
:func:`cap_torch_threads` at import, which gives each worker its share of
the cores (all of them when the tests run in one process).
"""
import os

import torch


def thread_share(cpus, workers) -> int:
    """Intra-op threads for one of ``workers`` processes on ``cpus``
    cores: an even share, at least 1."""
    return max(1, (cpus or 1) // max(1, workers))


def cap_torch_threads() -> int:
    """Set torch's intra-op threads to this process's share of the cores
    (``PYTEST_XDIST_WORKER_COUNT`` workers, 1 outside xdist); returns it."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    n = thread_share(os.cpu_count(), workers)
    torch.set_num_threads(n)
    return n


def test_thread_share():
    assert thread_share(8, 6) == 1
    assert thread_share(8, 1) == 8
    assert thread_share(8, 3) == 2
    assert thread_share(4, 8) == 1
    assert thread_share(None, 1) == 1
    assert thread_share(8, 0) == 8


def test_cap_follows_the_worker_count(monkeypatch):
    before = torch.get_num_threads()
    try:
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "6")
        assert cap_torch_threads() == thread_share(os.cpu_count(), 6)
        assert torch.get_num_threads() == thread_share(os.cpu_count(), 6)
        monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT")
        assert cap_torch_threads() == thread_share(os.cpu_count(), 1)
    finally:
        torch.set_num_threads(before)
