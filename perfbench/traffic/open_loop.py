"""Open loop: requests arrive on a schedule fixed in advance, whatever the
answers do, for the whole window.

Mix keys: ``rate_per_s``. The gaps between arrivals are the quantiles of
an exponential distribution of that rate (a Poisson stream's gaps), the
same set of ``round(rate * seconds)`` gaps for every seed, in an order
drawn from the seed. A request's latency counts from its scheduled time,
so a stall in sending counts against the requests it delays.
"""
from __future__ import annotations

import time
from typing import Callable, List

import numpy as np

from perfbench.harness.client import Record


def gaps(rate: float, seconds: float) -> np.ndarray:
    """The window's gaps between arrivals, ascending: exponential
    quantiles, scaled to fill the window."""
    n = max(1, int(round(rate * seconds)))
    g = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    return g * (seconds / g.sum())


def schedule(rate: float, seconds: float, rng) -> np.ndarray:
    """Arrival offsets (s) from the window's start."""
    g = gaps(rate, seconds)
    return np.cumsum(rng.permutation(g)) - g[0] / 2


def run(send: Callable[[Record], object], mix: dict, seconds: float,
        rng, clock: Callable[[], float]) -> List[Record]:
    offsets = schedule(float(mix["rate_per_s"]), seconds, rng)
    t0 = clock()
    records: List[Record] = []
    for i, off in enumerate(offsets):
        due = t0 + float(off)
        wait = due - clock()
        if wait > 0:
            time.sleep(wait)
        rec = Record(i=i, intended=due)
        records.append(rec)
        send(rec)
    left = t0 + seconds - clock()
    if left > 0:
        time.sleep(left)
    return records
