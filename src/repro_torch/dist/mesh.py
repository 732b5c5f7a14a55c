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

:func:`place_blocks` (and :func:`full_blocks`, which makes each device's
part on that device) places a tensor by a per-dim spec instead, the form
of ``dist/sharding.py``'s rules: each dim whole or split over a group of
axes, so two dims may split at once. The KV cache is laid out so
(``lm_cache_specs``: the batch over the FSDP axes, the slots over
``model``): shard (i, j) of a (data, model) mesh holds batch block i and
sequence block j on its own device, and a :class:`Blocks` value keeps one
block per shard with its offsets. The same rule holds: shards on one device
whose blocks tile one box share one copy, so S shards on one card still
cost one cache. For example, a (1, 4) mesh of two CPU devices::

    mesh = make_mesh((1, 4), ("data", "model"),
                     devices=["cpu", "cpu", "cpu:0", "cpu:0"])
    cache = init_cache(cfg, 1, 4096, torch.float32, mesh=mesh)
    cache["all"].k.bytes_by_device()    # half the stack on each device
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

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


def _axes(part) -> Tuple[str, ...]:
    """The mesh axes one spec entry splits over (``None``: none)."""
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def _group_size(mesh_shape: Mapping[str, int], axes) -> int:
    n = 1
    for a in axes:
        n *= int(mesh_shape[a])
    return n


def _layout(shape: Sequence[int], mesh: Mesh, spec: Sequence
            ) -> Tuple[Tuple[int, ...], Tuple[Tuple[int, ...], ...]]:
    """The block shape of a value of ``shape`` placed by ``spec`` (per dim
    ``None`` or the axes it splits over, dims past the spec whole), and
    each shard's block offset in every dim. A dim split over axes (a, b)
    takes block a_index * |b| + b_index, JAX's order."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    block = []
    for d, part in enumerate(spec):
        n = _group_size(mesh.shape, _axes(part))
        if shape[d] % n:
            raise ValueError(f"dim {d} of size {shape[d]} does not split "
                             f"over {n} shards")
        block.append(shape[d] // n)
    strides, n = {}, 1
    for a in reversed(mesh.axis_names):      # row-major shard coordinates
        strides[a], n = n, n * mesh.shape[a]
    starts = []
    for s in range(mesh.size):
        start = []
        for d, part in enumerate(spec):
            i = 0
            for a in _axes(part):
                i = i * mesh.shape[a] + (s // strides[a]) % mesh.shape[a]
            start.append(i * block[d])
        starts.append(tuple(start))
    return tuple(block), tuple(starts)


def _box(sts, block):
    """The box [lo, hi) that the blocks at offsets ``sts`` tile, or None
    where they leave holes in it."""
    nd = len(block)
    lo = tuple(min(st[d] for st in sts) for d in range(nd))
    hi = tuple(max(st[d] for st in sts) + block[d] for d in range(nd))
    tiles = 1
    for d in range(nd):
        tiles *= (hi[d] - lo[d]) // block[d]
    return (lo, hi) if tiles == len(sts) else None


def _place_blocks(shape, mesh: Mesh, spec, make):
    """Per-shard parts, their offsets and the one copy they all view (or
    None). A device holds one copy of the box its blocks span where they
    tile it, each block a view of it. Otherwise each run of consecutive
    shards on it holds one copy of the box its new blocks tile, a new run
    starting where a block would leave a hole (a dim split over every axis:
    runs of shards on one device share a copy, as :func:`place` lays a
    corpus out). ``make(lo, hi, device)`` returns the box [lo, hi) on
    ``device``."""
    block, starts = _layout(shape, mesh, spec)
    devs = mesh.devices
    held: Dict[torch.device, Dict[Tuple[int, ...], None]] = {}
    for s, st in enumerate(starts):
        held.setdefault(devs[s], {})[st] = None
    boxes = {}                      # (device, block offset) -> (lo, copy)
    for dev, sts in held.items():
        groups = [list(sts)]
        if _box(groups[0], block) is None:
            groups, seen = [[]], set()
            for s, st in enumerate(starts):
                if devs[s] != dev:
                    groups.append([])
                elif st not in seen:
                    seen.add(st)
                    if _box(groups[-1] + [st], block) is None:
                        groups.append([])
                    groups[-1].append(st)
        for group in filter(None, groups):
            lo, hi = _box(group, block)
            copy = make(lo, hi, dev)
            for st in group:
                boxes[dev, st] = (lo, copy)
    parts = []
    for s, st in enumerate(starts):
        lo, t = boxes[devs[s], st]
        for d in range(len(shape)):
            if block[d] != t.shape[d]:
                t = t.narrow(d, st[d] - lo[d], block[d])
        parts.append(t)
    copies = {id(t): t for _, t in boxes.values()}
    return tuple(parts), starts, (next(iter(copies.values()))
                                  if len(copies) == 1 else None)


def _copy_box(x: torch.Tensor):
    """``make`` for :func:`_place_blocks`: the box of ``x``, moved. A box
    that is not the whole of ``x`` is a copy even on ``x``'s own device, so
    that it keeps no other shard's rows alive."""
    def make(lo, hi, dev):
        box = x
        for d, (a, b) in enumerate(zip(lo, hi)):
            if b - a != x.shape[d]:
                box = box.narrow(d, a, b - a)
        moved = box.to(dev)
        if box is not x and moved.data_ptr() == box.data_ptr():
            moved = moved.clone()
        return moved
    return make


def _place_tensor(x: torch.Tensor, mesh: Mesh, dim: Optional[int]):
    """Per-shard parts of ``x`` and the one copy they view (or None)."""
    spec = () if dim is None else (None,) * dim + (mesh.axis_names,)
    parts, _, whole = _place_blocks(x.shape, mesh, spec, _copy_box(x))
    return parts, whole


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


# ---------------------------------------------------------------------------
# Placement by a per-dim spec (the KV cache's layout)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Blocks:
    """A tensor placed on a mesh by a per-dim ``spec`` (``dist/sharding.py``
    ``Spec``: per dim ``None`` or the axes it splits over): ``parts[s]`` is
    shard ``s``'s block on ``mesh.devices[s]``, ``starts[s]`` its offset in
    every dim of the global ``shape``. Shards that hold blocks on one device
    view that device's copy; a block held on two devices is a copy on each.
    ``whole`` is the one tensor every part is a view of, where all shards
    share one device."""

    parts: Tuple[torch.Tensor, ...]
    spec: Tuple[Any, ...]
    mesh: Mesh
    shape: Tuple[int, ...]
    starts: Tuple[Tuple[int, ...], ...]
    whole: Optional[torch.Tensor] = None

    @property
    def dtype(self):
        return self.parts[0].dtype

    def region(self, s: int) -> Tuple[slice, ...]:
        """Shard ``s``'s block as a global index."""
        return tuple(slice(a, a + n) for a, n in
                     zip(self.starts[s], self.parts[s].shape))

    def stored(self) -> Tuple[int, ...]:
        """One shard per stored block: the first, in shard order, of the
        shards that view each (device, block)."""
        first = {}
        for s, st in enumerate(self.starts):
            first.setdefault((self.mesh.devices[s], st), s)
        return tuple(first.values())

    def __getitem__(self, i: int) -> "Blocks":
        """Index ``i`` of the leading (unsplit) dim of every block, as a
        tensor's ``x[i]``: views, so a write lands in the stored blocks."""
        if _axes(self.spec[0]):
            raise ValueError("the leading dim is split over the mesh")
        return Blocks(tuple(p[i] for p in self.parts), self.spec[1:],
                      self.mesh, self.shape[1:],
                      tuple(st[1:] for st in self.starts),
                      None if self.whole is None else self.whole[i])

    def __setitem__(self, i: int, src: torch.Tensor) -> None:
        """``x[i] = src``: the global ``src`` into index ``i`` of every
        stored block."""
        self[i].copy_(src)

    def copy_(self, src: torch.Tensor) -> "Blocks":
        """Write the global ``src`` into every stored block (each from its
        own region, moved to the block's device)."""
        for s in self.stored():
            self.parts[s].copy_(src[self.region(s)])
        return self

    def gather(self) -> torch.Tensor:
        """The global value on the merge device (``devices[0]``): ``whole``
        where it exists, else the blocks copied into place. Either way the
        audit counts the global value's bytes as an all-gather."""
        note_collective("all-gather",
                        self.parts[0].element_size() * math.prod(self.shape))
        if self.whole is not None:
            return self.whole
        out = torch.empty(self.shape, dtype=self.dtype,
                          device=self.mesh.devices[0])
        for s in self.stored():
            out[self.region(s)].copy_(self.parts[s])
        return out

    def bytes_by_device(self) -> Dict[torch.device, int]:
        """Bytes of the storage the parts on each mesh device view, each
        storage counted once."""
        seen: Dict[torch.device, Dict[int, int]] = {}
        for s, p in enumerate(self.parts):
            st = p.untyped_storage()
            seen.setdefault(self.mesh.devices[s], {})[st.data_ptr()] = \
                st.nbytes()
        return {d: sum(v.values()) for d, v in seen.items()}


def place_blocks(x: torch.Tensor, mesh: Mesh, spec) -> Blocks:
    """Place ``x`` on ``mesh`` by ``spec``: shard (i, j) of a (data, model)
    mesh and a spec (``data``, ``model``) holds row block i and column block
    j. Each device holds its copy of the blocks its shards own (views where
    they tile one box, :func:`_place_blocks`); on one device, the copy is
    ``x`` itself."""
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    parts, starts, whole = _place_blocks(x.shape, mesh, spec, _copy_box(x))
    return Blocks(parts, spec, mesh, tuple(x.shape), starts, whole)


def full_blocks(shape: Sequence[int], fill, dtype, mesh: Mesh,
                spec) -> Blocks:
    """``torch.full(shape, fill)`` placed by ``spec``, each device's copy
    made on that device (no global tensor is built)."""
    def make(lo, hi, dev):
        return torch.full(tuple(b - a for a, b in zip(lo, hi)), fill,
                          dtype=dtype, device=dev)
    shape = tuple(shape)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    parts, starts, whole = _place_blocks(shape, mesh, spec, make)
    return Blocks(parts, spec, mesh, shape, starts, whole)
