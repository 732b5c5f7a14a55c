"""The per-device account of one step on a mesh (the torch counterpart of
the accounting half of ``repro.analysis.hlo_audit``).

The JAX package reads a cell's per-device FLOPs, bytes, memory and
collective traffic out of XLA's analysis of the lowered HLO module. The
port has no HLO, so its launcher builds an *account* of three kinds of
number, and each field of a record says which kind it holds:

**exact**
    Per-device argument and output bytes: for every leaf,
    ``prod(dist/sharding.shard_shape(shape, spec, mesh)) * itemsize``
    (:func:`placed_bytes`). XLA's ``argument_size_in_bytes`` is that sum
    too. Model FLOPs are the JAX package's analytic formulas
    (``launch/steps.py``).

**counted**
    The port's own step run once on ``meta`` tensors (no allocation, no
    card) under :func:`count_step`: ``FlopCounterMode``'s FLOPs, split by
    operand dtype, and the operand plus result bytes of every op that
    moves data (view ops left out). An eager step reads and writes every
    op's operands, so ``unfused_bytes`` is an upper bound on HBM traffic,
    not XLA's fused ``bytes accessed``; an in-place write into a slice of
    a big tensor (a decode cache slot) counts the whole slice.
    ``eager_live_peak_bytes`` is the most bytes held at once by tensors the
    step created (tracked by weakref: a view keeping a freed tensor's
    storage alive is not seen). Cross-shard traffic that the step itself
    reports through ``analysis/audit.py::note_collective`` (the ring
    collectives, the scorecard merge, the split-K combine) is kept by
    kind as ``noted_collective_bytes``.

**reckoned**
    Collective bytes from the specs, in JAX's convention: per device, the
    bytes of each collective's *result* shape (``collective_bytes`` reads
    the left-hand side of each HLO op), the ring factor 2(n - 1) / n
    taken as 1. Each :class:`Collective` names its kind and the mesh axes
    its group spans. The formulas, per step:

    * a parameter leaf with shard bytes ``s`` whose spec splits it over
      FSDP axes (every axis but ``model``) of product ``f``:
      ``all-gather`` of ``s * f`` (the block with its FSDP split undone,
      its ``model`` split kept) per pass that uses it; with gradients, a
      ``reduce-scatter`` of ``s`` (the gradient, in the leaf's dtype) over
      the same axes per pass. A leaf that is replicated over axes of
      product ``r > 1``: with gradients, an ``all-reduce`` of ``s`` over
      them per pass (:func:`param_collectives`). Embedding tables are not
      gathered (``gather=False``): they are looked up by row;
    * a lookup of ``rows`` rows of ``width`` from a table whose rows split
      over axes R: an ``all-reduce`` of ``rows * width * itemsize`` over R
      (each row owner contributes its rows; :func:`lookup_collective`);
    * tensor parallelism (a ``model`` axis of size > 1): an ``all-reduce``
      of the (rows, tokens, d_model) activation block a device holds after
      each row-parallel product, two per layer forward (attention out,
      FFN out) and two more backward; recomputation under remat is left
      out, so training's figure is a lower bound (:func:`tp_collectives`);
    * split-K decode over a sequence-split cache: per layer, an
      ``all-reduce`` of the float32 running max and denominator (B_loc,
      H) and the weighted values (B_loc, H, Dh) over the sequence axes,
      ``B_loc * H * (Dh + 2) * 4`` bytes;
    * PNA over edge shards: per layer an ``all-gather`` of the node
      features (N, d) float32 over every axis, and backward a
      ``reduce-scatter`` of their gradient, (N / n, d);
    * the sharded rerank: one ``all-gather`` of every shard's (B, K)
      float32 scores and int32 ids, ``2 * B * n * K * 4`` bytes
      (``audit.scorecard_budget_bytes`` without the bandit's two psums).

    Loss scalars and a vocab-split log-sum-exp (a few bytes per token) are
    left out. :func:`collective_seconds` prices each collective at the
    link its group crosses (:func:`link_of`): NVLink within a host of
    ``GPUS_PER_HOST`` cards, the NIC between hosts.

The module imports torch and the standard library only.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from collections import Counter
from typing import (Any, Callable, Dict, Iterable, List, Mapping, NamedTuple,
                    Sequence, Tuple)

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.analysis import audit
from repro_torch.dist.sharding import MODEL_AXIS, Spec, _axes, shard_shape

# Bytes per element (the counterpart of JAX's table of HLO dtype names).
DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.float8_e4m3fn: 1,
    torch.float8_e5m2: 1, torch.int16: 2, torch.bfloat16: 2,
    torch.float16: 2, torch.int32: 4, torch.float32: 4, torch.int64: 8,
    torch.float64: 8, torch.complex64: 8, torch.complex128: 16,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

GPUS_PER_HOST = 8


def itemsize(dtype: torch.dtype) -> int:
    """Bytes per element; an unknown dtype raises (a silent 0 would
    undercount)."""
    if dtype not in DTYPE_BYTES:
        raise ValueError(f"no byte size for {dtype}: add it to DTYPE_BYTES")
    return DTYPE_BYTES[dtype]


# ---------------------------------------------------------------------------
# exact: bytes of placed values
# ---------------------------------------------------------------------------

def shard_bytes(shape: Sequence[int], dtype: torch.dtype, spec: Spec,
                mesh_shape: Mapping[str, int]) -> int:
    """Bytes of one device's block of a value placed by ``spec``."""
    return math.prod(shard_shape(shape, spec, mesh_shape)) * itemsize(dtype)


def placed_leaves(tree, specs) -> List[Tuple[str, torch.Tensor, Spec]]:
    """(path, tensor, spec) of every tensor of ``tree``, walked beside
    ``specs``, which has ``tree``'s structure with a spec in place of each
    tensor and a name -> spec dict in place of each ``nn.Module``."""
    out: List[Tuple[str, torch.Tensor, Spec]] = []

    def walk(x, s, path):
        if x is None:
            return
        if isinstance(x, torch.Tensor):
            out.append((path, x, tuple(s)))
        elif isinstance(x, nn.Module):
            for name, p in x.named_parameters():
                out.append((f"{path}.{name}" if path else name, p,
                            tuple(s[name])))
        elif isinstance(x, Mapping):
            for k in x:
                walk(x[k], s[k], f"{path}.{k}" if path else str(k))
        elif isinstance(x, (tuple, list)):
            if len(x) != len(s):
                raise ValueError(f"{path}: {len(x)} values, {len(s)} specs")
            names = getattr(x, "_fields", None) or range(len(x))
            for k, a, b in zip(names, x, s):
                walk(a, b, f"{path}.{k}" if path else str(k))
        else:
            raise TypeError(f"{path}: cannot place a {type(x).__name__}")

    walk(tree, specs, "")
    return out


def placed_bytes(tree, specs, mesh_shape: Mapping[str, int]) -> int:
    """Per-device bytes of ``tree`` placed by ``specs`` (exact)."""
    return sum(shard_bytes(t.shape, t.dtype, s, mesh_shape)
               for _, t, s in placed_leaves(tree, specs))


def memory_stats(args, in_specs, outs, out_specs,
                 mesh_shape: Mapping[str, int]) -> Dict[str, int]:
    """The account's exact memory figures per device: argument and output
    bytes (the counted eager live peak is :func:`peak_buffer_bytes`)."""
    return {"exact_argument_bytes": placed_bytes(args, in_specs, mesh_shape),
            "exact_output_bytes": placed_bytes(outs, out_specs, mesh_shape)}


# ---------------------------------------------------------------------------
# counted: one run of the step on meta
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Count:
    """What one counted run saw (totals of the run, not per device)."""
    flops: int = 0
    flops_by_dtype: Dict[str, int] = dataclasses.field(default_factory=dict)
    unfused_bytes: int = 0
    ops: int = 0
    eager_live_peak_bytes: int = 0
    noted_collective_bytes: Dict[str, int] = dataclasses.field(
        default_factory=dict)


def _is_view(func) -> bool:
    """An op whose results alias an input without writing it (a view or a
    metadata op): it moves no data."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _op_dtype(args) -> str:
    for t in tree_leaves(args):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            return str(t.dtype).replace("torch.", "")
    return "other"


class _Counting(TorchDispatchMode):
    """FLOPs by dtype (``FlopCounterMode``'s formulas), unfused bytes, ops
    and the eager live peak of one run; reads nothing of the values, so
    it runs on ``meta`` as on a device."""

    def __init__(self):
        super().__init__()
        self.flops: Counter = Counter()
        self.collective: Counter = Counter()   # audit.note_collective's sink
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops[_op_dtype(args)] += int(
                formula(*args, **kwargs, out_val=out))
        if not _is_view(func):
            inputs = [t for t in tree_leaves((args, kwargs))
                      if isinstance(t, torch.Tensor)]
            seen = {id(t) for t in inputs}
            self.bytes += sum(t.numel() * t.element_size() for t in inputs)
            for t in tree_leaves(out):
                if not isinstance(t, torch.Tensor):
                    continue
                n = t.numel() * t.element_size()
                self.bytes += n
                if id(t) not in seen:            # a new tensor, not self
                    self.live += n
                    weakref.finalize(t, self._free, n)
            self.peak = max(self.peak, self.live)
        return out


def count_step(fn: Callable, *args, **kwargs) -> Tuple[Any, Count]:
    """Run ``fn(*args, **kwargs)`` once under ``FlopCounterMode`` and the
    counting mode: (its result, the :class:`Count`). The FLOPs are
    ``FlopCounterMode``'s total; the per-dtype split uses the same
    formulas and must add up to it."""
    counter = _Counting()
    prev = getattr(audit._LISTENERS, "recorder", None)
    audit._LISTENERS.recorder = counter
    try:
        with FlopCounterMode(display=False) as fc, counter:
            out = fn(*args, **kwargs)
    finally:
        audit._LISTENERS.recorder = prev
    total = int(fc.get_total_flops())
    if sum(counter.flops.values()) != total:
        raise RuntimeError(
            f"per-dtype FLOPs {dict(counter.flops)} do not add up to "
            f"FlopCounterMode's {total}")
    return out, Count(flops=total, flops_by_dtype=dict(counter.flops),
                      unfused_bytes=counter.bytes, ops=counter.ops,
                      eager_live_peak_bytes=counter.peak,
                      noted_collective_bytes=dict(counter.collective))


def flops_and_bytes(count: Count) -> Dict[str, float]:
    """The counted FLOPs and unfused bytes of a run (totals)."""
    return {"counted_flops": float(count.flops),
            "counted_unfused_bytes": float(count.unfused_bytes)}


def peak_buffer_bytes(count: Count) -> float:
    """The counted eager live peak of a run: bytes the step's own tensors
    held at once, above its arguments."""
    return float(count.eager_live_peak_bytes)


# ---------------------------------------------------------------------------
# reckoned: collectives from the specs
# ---------------------------------------------------------------------------

class Collective(NamedTuple):
    kind: str                    # one of COLLECTIVES
    nbytes: int                  # per device, the result's bytes
    axes: Tuple[str, ...]        # the mesh axes its group spans


def collective_bytes(items: Iterable[Collective]) -> Dict[str, int]:
    """Bytes per collective kind, plus ``total`` (JAX's dict)."""
    out: Dict[str, int] = Counter()
    for c in items:
        if c.kind not in COLLECTIVES:
            raise ValueError(f"unknown collective kind {c.kind!r}")
        out[c.kind] += int(c.nbytes)
        out["total"] += int(c.nbytes)
    return dict(out)


def _split_axes(spec: Spec) -> Tuple[str, ...]:
    return tuple(a for part in spec for a in _axes(part))


def param_collectives(leaves: Iterable[Tuple[Sequence[int], torch.dtype,
                                             Spec]],
                      mesh_shape: Mapping[str, int], *, uses: int,
                      grads: int, gather: bool = True) -> List[Collective]:
    """The reckoned traffic of parameter leaves (shape, dtype, spec) over
    a step: ``uses`` passes that read each leaf (its FSDP all-gather each),
    ``grads`` passes that make its gradient (a reduce-scatter over its
    FSDP axes, an all-reduce over the axes it is replicated on)."""
    out: List[Collective] = []
    names = tuple(mesh_shape)
    for shape, dtype, spec in leaves:
        s = shard_bytes(shape, dtype, spec, mesh_shape)
        split = _split_axes(spec)
        fsdp = tuple(a for a in split if a != MODEL_AXIS)
        f = math.prod(mesh_shape[a] for a in fsdp)
        rep = tuple(a for a in names if a not in split)
        if gather and f > 1:
            out += [Collective("all-gather", s * f, fsdp)] * uses
            out += [Collective("reduce-scatter", s, fsdp)] * grads
        if rep and math.prod(mesh_shape[a] for a in rep) > 1:
            out += [Collective("all-reduce", s, rep)] * grads
    return out


def lookup_collective(rows: int, width: int, dtype: torch.dtype,
                      row_axes: Tuple[str, ...],
                      mesh_shape: Mapping[str, int]) -> List[Collective]:
    """An embedding lookup of ``rows`` rows from a table whose rows split
    over ``row_axes``: the all-reduce of the looked-up block (nothing when
    the table is whole on every device)."""
    if not row_axes or math.prod(mesh_shape[a] for a in row_axes) == 1:
        return []
    return [Collective("all-reduce", rows * width * itemsize(dtype),
                       tuple(row_axes))]


def tp_collectives(n_layers: int, rows: int, tokens: int, d_model: int,
                   dtype: torch.dtype, mesh_shape: Mapping[str, int], *,
                   train: bool) -> List[Collective]:
    """Tensor parallelism's activation all-reduces: two per layer forward
    and two more backward, each of the (rows, tokens, d_model) block a
    device holds."""
    if mesh_shape.get(MODEL_AXIS, 1) == 1:
        return []
    per = (4 if train else 2) * n_layers
    return [Collective("all-reduce", rows * tokens * d_model
                       * itemsize(dtype), (MODEL_AXIS,))] * per


def link_of(axes: Sequence[str], mesh_shape: Mapping[str, int],
            gpus_per_host: int = GPUS_PER_HOST) -> str:
    """``"nvlink"`` when the group of ``axes`` through device 0 lies in one
    host (devices numbered row-major over the mesh, ``gpus_per_host`` to a
    host), else ``"nic"``."""
    names = tuple(mesh_shape)
    strides, mul = {}, 1
    for a in reversed(names):
        strides[a] = mul
        mul *= int(mesh_shape[a])
    ids = [0]
    for a in axes:
        ids = [i + k * strides[a] for i in ids
               for k in range(int(mesh_shape[a]))]
    return "nvlink" if len({i // gpus_per_host for i in ids}) == 1 else "nic"


def collective_seconds(items: Iterable[Collective],
                       mesh_shape: Mapping[str, int],
                       link_bw: Mapping[str, float]
                       ) -> Tuple[float, Dict[str, int]]:
    """(seconds, bytes per link): each collective's bytes over the rate of
    the link its group crosses."""
    secs, per_link = 0.0, Counter()
    for c in items:
        link = link_of(c.axes, mesh_shape)
        per_link[link] += int(c.nbytes)
        secs += c.nbytes / link_bw[link]
    return secs, dict(per_link)
