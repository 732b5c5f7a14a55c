"""Device meshes and the corpus placement table (port of
``repro.launch.mesh.make_host_mesh`` and of the corpus rules of
``repro.dist.sharding``).

JAX runs a mesh from one controller: one process drives every device and
``shard_map`` runs a function per shard. This port does the same in one
process. A :class:`Mesh` is a list of torch devices, one per shard in
row-major order over its axes, and the list may repeat a device (S shards
on one card). A sharded step runs each shard's function on that shard's
device, and each collective is an explicit copy to the merge device
(``devices[0]``): JAX's tiled ``all_gather`` is a shard-major ``torch.cat``
and ``psum`` a sum in shard order.

A placement is the dim a value splits over every mesh axis (an int) or
``None`` for a value every shard holds whole. :func:`place` applies one:
shards that share a device and own neighbouring blocks share one copy, each
a view of it, so S shards on one card cost one corpus, not S.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.audit import nbytes, note_collective
from repro_torch.kernels.quant import QuantTokens


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named device grid: ``shape`` maps each axis name to its size (as
    JAX's ``mesh.shape``), ``devices`` holds one device per shard in
    row-major order over ``axis_names``."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        """Number of shards (the product of the axis sizes)."""
        return len(self.devices)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              device="cuda", devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over ``axis_names`` (``jax.make_mesh``). Every
    shard sits on ``device`` unless ``devices`` lists one per shard."""
    shape = tuple(int(n) for n in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names) or any(n < 1 for n in shape):
        raise ValueError(f"mesh shape {shape} does not fit axes "
                         f"{axis_names}")
    n = 1
    for s in shape:
        n *= s
    if devices is None:
        devs = (_device(device),) * n
    else:
        devs = tuple(_device(d) for d in devices)
        if len(devs) != n:
            raise ValueError(f"{len(devs)} devices for a mesh of {n} shards")
    return Mesh(axis_names, dict(zip(axis_names, shape)), devs)


def mesh_devices(n_shards: int, device="cuda") -> Tuple[torch.device, ...]:
    """One device per shard, as ``jax.make_mesh`` places a mesh: on CUDA,
    shard ``i`` on ``cuda:i`` when the host has at least ``n_shards``
    cards; with fewer cards (one card serving S shards) or off CUDA, every
    shard on ``device``."""
    if torch.device(device).type == "cuda" \
            and torch.cuda.device_count() >= n_shards:
        return tuple(torch.device("cuda", i) for i in range(n_shards))
    return (_device(device),) * n_shards


def make_host_mesh(n_devices: int = 0, *, axes=("data", "model"),
                   device="cuda") -> Mesh:
    """Small mesh of ``n_devices`` shards (default: one per visible card,
    or 1 on the CPU), favouring the ``model`` axis as
    ``repro.launch.mesh.make_host_mesh`` does, placed by
    :func:`mesh_devices`: one card per shard where there are enough."""
    n = n_devices or (torch.cuda.device_count()
                      if torch.device(device).type == "cuda" else 1)
    shape = (n,)
    if len(axes) == 2:
        model = next(m for m in (8, 4, 2, 1) if n % m == 0)
        shape = (n // model, model)
    return make_mesh(shape, axes, devices=mesh_devices(n, device))


# ---------------------------------------------------------------------------
# Corpus placement table (repro.dist.sharding.corpus_axes / corpus_specs)
# ---------------------------------------------------------------------------

def corpus_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The axes the corpus doc dim splits over: every mesh axis. The (C, L,
    M) index is the big object in late-interaction serving, so it takes
    the whole machine; queries replicate and the only cross-shard traffic
    is K-sized scorecards."""
    return tuple(mesh.axis_names)


def corpus_specs(mesh: Mesh) -> Dict[str, Optional[int]]:
    """Placement per ``ShardedCorpus`` field: the doc dim (0) over every
    axis for the token index and its planes, ``None`` (whole on every
    shard) for the residual codebook and the router state."""
    del mesh          # every field's placement is the same on any mesh
    return {"embs": 0,            # (C, L, M)
            "mask": 0,            # (C, L)
            "pooled": 0,          # (C, M) two-phase summaries
            "scales": 0,          # (C, L) quantized-corpus sidecars
            "codes": 0,           # (C, L)
            "codebook": None,     # (Kc, M) read by every shard
            "centroids": None,    # (Kc, M) router state, tiny
            "shard_mass": None}   # (Kc, n_shards)


@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    """A value placed on a mesh: ``parts[s]`` is shard ``s``'s local value
    (a tensor or a ``QuantTokens``) on ``mesh.devices[s]``, split on
    ``dim`` or whole (``dim=None``). ``whole`` is the one tensor every
    part is a view of, where all shards share one device."""

    parts: Tuple[Any, ...]
    dim: Optional[int]
    mesh: Mesh
    whole: Any = None

    @property
    def shape(self) -> Tuple[int, ...]:
        """The global shape (the split dim summed over the shards)."""
        shape = list(self.parts[0].shape)
        if self.dim is not None:
            shape[self.dim] = sum(p.shape[self.dim] for p in self.parts)
        return tuple(shape)

    @property
    def dtype(self):
        return self.parts[0].dtype

    def gather(self):
        """The global value on the merge device (``all_gather``): ``whole``
        where it exists, else the parts concatenated in shard order. Either
        way the audit counts the bytes every shard contributes."""
        if self.dim is not None:
            note_collective("all-gather", sum(
                nbytes(*[a for a in p if a is not None])
                if isinstance(p, QuantTokens) else nbytes(p)
                for p in self.parts))
        if self.whole is not None or self.dim is None:
            return self.parts[0] if self.whole is None else self.whole
        dev = self.mesh.devices[0]
        if isinstance(self.parts[0], QuantTokens):
            leaves = zip(*self.parts)
            return QuantTokens(*(
                None if ls[0] is None else
                ls[0].to(dev) if i == 3 else
                torch.cat([x.to(dev) for x in ls], dim=self.dim)
                for i, ls in enumerate(leaves)))
        return torch.cat([p.to(dev) for p in self.parts], dim=self.dim)


def _place_tensor(x: torch.Tensor, mesh: Mesh, dim: Optional[int]):
    """Per-shard parts of ``x`` and the one copy they view (or None)."""
    devs = mesh.devices
    if dim is None:
        copies = {d: x.to(d) for d in dict.fromkeys(devs)}
        parts = tuple(copies[d] for d in devs)
        return parts, (parts[0] if len(copies) == 1 else None)
    S = len(devs)
    if x.shape[dim] % S:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over {S} shards")
    c = x.shape[dim] // S
    parts = [None] * S
    blocks = []
    s = 0
    while s < S:                 # runs of shards on one device share a copy
        e = s
        while e + 1 < S and devs[e + 1] == devs[s]:
            e += 1
        block = x.narrow(dim, s * c, (e - s + 1) * c)
        moved = block.to(devs[s])
        if moved.data_ptr() == block.data_ptr() and (e - s + 1) < S:
            moved = moved.clone()   # keep no other shard's rows alive
        blocks.append(moved)
        for j in range(s, e + 1):
            parts[j] = moved.narrow(dim, (j - s) * c, c)
        s = e + 1
    return tuple(parts), (blocks[0] if len(blocks) == 1 else None)


def place(x, mesh: Mesh, dim: Optional[int]) -> Sharded:
    """Place a tensor or a ``QuantTokens`` on ``mesh`` split on ``dim`` (or
    whole on every shard with ``None``). A ``QuantTokens`` places its
    payload and planes on ``dim`` and its codebook whole."""
    if isinstance(x, Sharded):
        raise ValueError("value is already placed on a mesh")
    if isinstance(x, QuantTokens):
        leaves = [None if a is None else
                  _place_tensor(a, mesh, None if i == 3 else dim)
                  for i, a in enumerate(x)]
        parts = tuple(QuantTokens(*(None if lf is None else lf[0][s]
                                    for lf in leaves))
                      for s in range(mesh.size))
        whole = (QuantTokens(*(None if lf is None else lf[1]
                               for lf in leaves))
                 if leaves[0][1] is not None else None)
        return Sharded(parts, dim, mesh, whole)
    parts, whole = _place_tensor(x, mesh, dim)
    return Sharded(parts, dim, mesh, whole)


def shard_parts(x, mesh: Mesh, dim: Optional[int] = 0) -> Tuple[Any, ...]:
    """Shard ``s``'s local value of an operand, for every ``s`` (what a
    ``shard_map`` in_spec does): a :class:`Sharded` value gives its parts,
    anything else is placed on ``dim`` first (an unplaced tensor's split
    must divide, as ``shard_map`` requires)."""
    if isinstance(x, Sharded):
        if x.mesh.size != mesh.size or x.dim != dim:
            raise ValueError(f"operand placed on {x.mesh.size} shards, dim "
                             f"{x.dim}; the step wants {mesh.size}, dim {dim}")
        return x.parts
    return place(x, mesh, dim).parts
