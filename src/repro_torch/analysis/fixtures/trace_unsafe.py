"""Trigger fixture for the trip-safety rules (never executed; the lint
works on the AST). Expected violations, in order: prng-aliasing,
mutable-default, then in the traced functions traced-truthiness,
traced-cast (x2), host-sync-in-trace, time-in-trace, and in ``fused_trip``
(a trip by name), the ``torch.compile`` function and the captured graph
block: traced-truthiness, host-sync-in-trace (x3), traced-cast."""
import time

import numpy as np
import torch


def aliased_seed(seed: int):
    return torch.manual_seed(seed + 7)                 # prng-aliasing


def mutable_default(xs=[]):                            # mutable-default
    return xs


def round_loop(run_loop, x):
    def trip(state, active):
        if torch.any(state > 0):                       # traced-truthiness
            state = state - 1
        v = float(torch.sum(state))                    # traced-cast
        w = state.max().item()                         # traced-cast
        host = np.asarray(state)                       # host-sync-in-trace
        t = time.time()                                # time-in-trace
        return state - v - w - host.mean() - t, active

    return run_loop(trip, x)


def fused_trip(state, active):
    while state.any():                                 # traced-truthiness
        state = state - 1
    ids = state.tolist()                               # host-sync-in-trace
    return state.cpu(), active, ids                    # host-sync-in-trace


@torch.compile
def compiled_step(x):
    torch.cuda.synchronize()                           # host-sync-in-trace
    return x * 2


def capture(graph, x):
    with torch.cuda.graph(graph):
        y = int(torch.count_nonzero(x))                # traced-cast
    return y
