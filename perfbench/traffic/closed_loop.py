"""Closed loop: ``outstanding`` clients, each sending its next request as
soon as the answer to its last one arrives, until the window closes.

Mix keys: ``outstanding``. A request's intended send time is the moment
its client was free to send it.
"""
from __future__ import annotations

from concurrent.futures import FIRST_COMPLETED, wait
from typing import Callable, List

from perfbench.harness.client import Record


def run(send: Callable[[Record], object], mix: dict, seconds: float,
        rng, clock: Callable[[], float]) -> List[Record]:
    del rng   # every client sends at once; arrivals follow the answers
    records: List[Record] = []
    pending = set()

    def issue() -> None:
        rec = Record(i=len(records), intended=clock())
        records.append(rec)
        fut = send(rec)
        if fut is not None:
            pending.add(fut)

    t_end = clock() + seconds
    for _ in range(int(mix["outstanding"])):
        issue()
    while pending:
        left = t_end - clock()
        if left <= 0:
            break
        done, _ = wait(pending, timeout=left, return_when=FIRST_COMPLETED)
        for fut in done:
            pending.discard(fut)
            if clock() < t_end:
                issue()
    return records
