"""Ring collectives over the one-process mesh (port of
``repro.dist.collectives``).

JAX runs these under ``shard_map``: ``ring_all_gather`` passes each
shard's chunk one hop around the ring per step (``ppermute``), so every
link carries 1/n of the payload a step and no bulk all-gather is lowered.
The port's :class:`~repro_torch.dist.mesh.Mesh` is a device list driven
from one process, so each function here takes one tensor per shard, in
shard order, and returns one per shard on that shard's device. Each of the
n - 1 hops is an explicit copy of a shard's buffer to the next shard's
device (a copy even where the two shards share a card), and each hop's
bytes (every shard's buffer) are reported to the audit as
``collective-permute`` traffic (:func:`repro_torch.analysis.audit.
note_collective`).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.analysis.audit import nbytes, note_collective


def ring_all_gather(parts: Sequence[torch.Tensor],
                    mesh) -> List[torch.Tensor]:
    """All-gather shard ``s``'s ``parts[s]`` (r, ...) -> (n * r, ...) on
    every shard, in n - 1 ring hops. Chunk j of every result is shard j's,
    so a result is the shard-major concatenation (JAX's tiled
    ``all_gather``)."""
    n = mesh.size
    if len(parts) != n:
        raise ValueError(f"{len(parts)} parts for a mesh of {n} shards")
    devs = mesh.devices
    bufs = [p.to(devs[i]) for i, p in enumerate(parts)]
    if n == 1:
        return bufs
    # received[i][k]: what shard i holds after k hops, shard (i - k) mod n's
    # chunk.
    received = [[b] for b in bufs]
    for _ in range(n - 1):
        note_collective("collective-permute", nbytes(*bufs))
        bufs = [bufs[(i - 1) % n].to(devs[i], copy=True) for i in range(n)]
        for i in range(n):
            received[i].append(bufs[i])
    # Reorder to source order 0..n-1: source j arrived after (i - j) mod n
    # hops.
    return [torch.cat([received[i][(i - j) % n] for j in range(n)], dim=0)
            for i in range(n)]


def ring_matmul(parts: Sequence[torch.Tensor], w: torch.Tensor,
                mesh) -> List[torch.Tensor]:
    """Row-sharded ``X @ w`` rebuilt on every shard: ``parts[s]`` is shard
    ``s``'s (rows / n, K) block of X, ``w`` (K, N) is whole on every shard.
    Each shard multiplies its block, then the (rows / n, N) products ride
    the ring (n - 1 hops of 1/n of the output each)."""
    local = [p @ w.to(p.device) for p in parts]
    return ring_all_gather(local, mesh)
