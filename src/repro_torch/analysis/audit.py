"""Serving-contract audit of a warmed step (the torch meaning of
``repro.analysis.hlo_audit``).

The JAX package audits the optimized HLO of each AOT executable. The port
has no HLO: a warmed bucket is a Python step that issues aten ops. So a
bucket is audited by running it once, on its bucket's shapes, under a
recorder (:class:`Recorder`, a ``TorchDispatchMode``, which sees every aten
op the step issues on the CPU and on the card, in the calling thread), and
the recorded ops are held to the JAX rules. The rule ids are the JAX
package's, so callers switch on :attr:`AuditError.rule` alike:

``hlo-host-sync``
    A host read inside a step: ``.item()``, ``bool()``, ``int()`` and
    ``float()`` of a tensor (``aten._local_scalar_dense``, seen on every
    device), a copy from the card to the host (``.cpu()``, ``.tolist()``
    or ``.numpy()`` of a CUDA tensor: a dispatched ``_to_copy`` or
    ``copy_``; on the CPU these dispatch nothing and are not seen), and an
    op whose output size depends on the data (``nonzero``, boolean
    indexing, ``unique``, ``masked_select``, ``repeat_interleave`` without
    ``output_size``: recorded on every device, since on the card each one
    waits for the device). Each read is attributed to its site, the
    innermost frame in ``repro_torch`` (``core/frontier.py::run_loop``).
    A read inside a trip function (``fused_trip``, ``chain_trip``) always
    fails: a trip must stay capturable as a CUDA graph. Any other read
    fails unless the spec allows its site, with at most its count.
``hlo-f64``
    Any op output in float64 or complex128.
``hlo-corpus-promotion``
    A bf16 / f16 resident corpus (or ``audit_require_bf16``) promoted: an
    f32 tensor of at least the corpus's element count among the step's
    operands, the program boundary. As in the JAX rule, upcasts inside the
    step are the f32-accumulation contract and pass (stage 1 upcasts the
    token matrix it scans, as the reference's ``generate_candidates``
    does).
``hlo-int8-residency``
    A quantized corpus must cross the boundary at int8 (an int8 operand
    of the payload's size, and no corpus-sized f32 / bf16 operand), and,
    since the port's step is eager, no op may read the payload and write it
    whole in f32 / bf16 (dequantized whole, the residency the compressed
    format exists to save). In-kernel and per-chunk dequantization are
    smaller and pass.
``hlo-collective-budget``
    Cross-shard traffic above the budget. The port's collectives are
    copies to the merge device (``mesh.devices[0]``); on one card they are
    views that move nothing, so the merge points report the *logical*
    bytes (:func:`note_collective`): the gathered
    scorecards of ``_merge_scorecards`` and ``Sharded.gather`` (the bytes
    all shards contribute) and the scalar cross-shard sums (one operand),
    the per-replica operand bytes JAX's ``collective_bytes`` counts.
``hlo-peak-buffer``
    The step's peak memory above the bound: on the card
    ``torch.cuda.max_memory_allocated()`` above the step's entry
    allocation (after ``reset_peak_memory_stats``); on the CPU, a stated
    proxy, the largest single tensor an op produced.

The module imports torch and the standard library only.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import threading
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_THIS = os.path.abspath(__file__)
TRIP_FUNCTIONS = ("fused_trip", "chain_trip")

_aten = torch.ops.aten
_SCALAR_READS = (_aten._local_scalar_dense.default,)
_COPIES = (_aten._to_copy.default, _aten.copy_.default)
# Ops whose output size depends on the values of their input: the card
# must finish the input and tell the host the size before they return.
_SHAPE_READS = (_aten.nonzero.default, _aten.masked_select.default,
                _aten._unique2.default, _aten.unique_dim.default,
                _aten.unique_consecutive.default,
                _aten.argwhere.default)
_INDEX_OPS = (_aten.index.Tensor, _aten.index_put.default,
              _aten.index_put_.default, _aten._index_put_impl_.default)
_WIDE = (torch.float32, torch.bfloat16, torch.float16)
_BAD_DTYPES = (torch.float64, torch.complex128)

HLO_DTYPES = {torch.bfloat16: "bf16", torch.float16: "f16",
              torch.float32: "f32", torch.float64: "f64", torch.int8: "s8"}


def scorecard_budget_bytes(batch: int, shards: int, topk: int) -> int:
    """The one-shard_map pipeline's cross-shard traffic contract: per
    shard, a (B, K) f32 score + (B, K) s32 gid scorecard all-gather, plus
    two f32[B] scalar psums (revealed-cell and total-cell counts)."""
    return 2 * batch * shards * topk * 4 + 2 * batch * 4


@dataclasses.dataclass(frozen=True)
class AuditSpec:
    """What one warmed step is allowed to do.

    ``collective_budget``: max logical cross-shard bytes (0 = none
    allowed, None = unaudited). ``peak_bytes``: max peak (None =
    unaudited). ``corpus_dtype`` + ``corpus_elems``: the resident corpus's
    dtype tag and payload element count per shard (``bf16``/``f16`` arm
    the promotion rule, ``s8`` the int8-residency rule).
    ``allowed_reads``: host-read sites the step may have (see the module
    docstring), each with its most reads or None for a data-dependent
    count (a trip loop's test: one per trip); a trip function is never
    allowed."""

    collective_budget: Optional[int] = None
    peak_bytes: Optional[int] = None
    corpus_dtype: Optional[str] = None
    corpus_elems: int = 0
    allowed_reads: Dict[str, Optional[int]] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class AuditReport:
    label: str
    collective_total: int
    collective: Dict[str, int]
    peak_bytes: Optional[float] = None
    # Host reads per site, trips run (trip-function entries) and ops seen.
    host_reads: Dict[str, int] = dataclasses.field(default_factory=dict)
    trips: int = 0
    ops: int = 0


class AuditError(RuntimeError):
    """A warmed step broke a serving contract. ``rule`` is the
    machine-readable id; ``lines`` carry the offending ops and sites."""

    def __init__(self, rule: str, label: str, detail: str,
                 lines: Optional[List[str]] = None):
        self.rule = rule
        self.label = label
        self.lines = list(lines or [])
        prov = "".join(f"\n    {ln[:200]}" for ln in self.lines[:4])
        more = (f"\n    ... and {len(self.lines) - 4} more"
                if len(self.lines) > 4 else "")
        super().__init__(f"[{rule}] {label}: {detail}{prov}{more}")


# ---------------------------------------------------------------------------
# Collective accounting: merge points report their logical bytes
# ---------------------------------------------------------------------------

_LISTENERS = threading.local()


def note_collective(kind: str, nbytes: int) -> None:
    """Report ``nbytes`` of logical cross-shard traffic of ``kind``
    (``all-gather``, ``all-reduce``) to the recorder of this thread, if
    one is running; a no-op otherwise."""
    rec = getattr(_LISTENERS, "recorder", None)
    if rec is not None:
        rec.collective[kind] += int(nbytes)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------

def _site(frame) -> str:
    path = os.path.relpath(frame.f_code.co_filename, _PKG)
    return f"{path.replace(os.sep, '/')}::{frame.f_code.co_name}"


def _frames():
    """(innermost repro_torch frame, the enclosing trip frame or None),
    walking out from the op's caller."""
    f = sys._getframe(2)
    inner = trip = None
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(_PKG) and fn != _THIS:
            if inner is None:
                inner = f
            if f.f_code.co_name in TRIP_FUNCTIONS:
                trip = f
                break
        f = f.f_back
    return inner, trip


def _where(frame) -> str:
    if frame is None:
        return "<outside repro_torch>"
    return f"{_site(frame)}:{frame.f_lineno}"


def _storages(leaves) -> set:
    out = set()
    for t in leaves:
        if isinstance(t, torch.Tensor):
            try:
                out.add((t.device, t.untyped_storage().data_ptr()))
            except RuntimeError:
                pass
    return out


def _host_read_kind(func, args, kwargs) -> Optional[str]:
    if func in _SCALAR_READS:
        return "scalar read"
    if func in _SHAPE_READS:
        return "data-dependent size"
    if func is _aten.repeat_interleave.Tensor \
            and kwargs.get("output_size") is None:
        return "data-dependent size"
    if func in _INDEX_OPS:
        idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
        if any(isinstance(i, torch.Tensor)
               and i.dtype in (torch.bool, torch.uint8) for i in idx or ()):
            return "data-dependent size"
    if func in _COPIES:
        if func is _aten._to_copy.default:
            src, dst = args[0].device, kwargs.get("device") or args[0].device
        else:
            dst, src = args[0].device, args[1].device
        if torch.device(src).type != "cpu" \
                and torch.device(dst).type == "cpu":
            return "copy to the host"
    return None


class Recorder(TorchDispatchMode):
    """Records what one run of a step does: host reads by site (and any
    inside a trip function), f64 outputs, corpus-sized widenings of the
    corpus payload, the largest tensor an op produced, trips entered and
    the logical collective bytes the merge points report."""

    def __init__(self, corpus: Sequence[torch.Tensor] = (),
                 corpus_elems: int = 0):
        super().__init__()
        self._corpus = _storages(corpus)
        self._corpus_elems = corpus_elems
        self.reads: List[Tuple[str, str, bool]] = []   # site, detail, trip
        self.f64: List[str] = []
        self.widened: List[str] = []
        self.largest = 0
        self.trips = 0
        self.ops = 0
        self.collective: Counter = Counter()
        self._trip = None

    def __enter__(self):
        self._outer = getattr(_LISTENERS, "recorder", None)
        _LISTENERS.recorder = self
        return super().__enter__()

    def __exit__(self, *exc):
        _LISTENERS.recorder = self._outer
        self._trip = None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        inner, trip = _frames()
        if trip is not None and trip is not self._trip:
            self.trips += 1
            self._trip = trip          # held, so its identity is not reused
        kind = _host_read_kind(func, args, kwargs)
        if kind is not None:
            site = "<outside repro_torch>" if inner is None else _site(inner)
            self.reads.append((site, f"{kind} ({func}) at {_where(inner)}"
                               + (f" inside {trip.f_code.co_name}"
                                  if trip is not None else ""),
                               trip is not None))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self.largest = max(self.largest, nbytes(t))
            if t.dtype in _BAD_DTYPES:
                self.f64.append(f"{func} -> {t.dtype} {tuple(t.shape)} at "
                                f"{_where(inner)}")
        if self._corpus and self._corpus_elems > 0:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            if _storages(ins) & self._corpus:
                for t in outs:
                    if t.dtype in _WIDE and t.numel() >= self._corpus_elems:
                        self.widened.append(
                            f"{func} -> {t.dtype} {tuple(t.shape)} from the "
                            f"corpus at {_where(inner)}")
        return out


def operand_tensors(args) -> List[torch.Tensor]:
    """Every tensor of a step's operands: tensors, sequences, NamedTuples
    (``QuantTokens``) and mesh-placed values (their per-shard parts)."""
    out: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif hasattr(x, "parts") and hasattr(x, "mesh"):
            walk(x.parts)
    walk(args)
    return out


def audit_step(run: Callable[[], Any], spec: AuditSpec = AuditSpec(), *,
               label: str = "<step>", operands: Sequence[Any] = (),
               corpus: Sequence[torch.Tensor] = (),
               device=None) -> AuditReport:
    """Run ``run()`` once under a :class:`Recorder` and hold what it did
    to ``spec``; raises :class:`AuditError` on the first broken rule (in
    the JAX order: host sync, f64, promotion, int8 residency, collective
    budget, peak) and returns the report otherwise.

    ``operands`` are the step's inputs (the program boundary of the
    residency rules), ``corpus`` the tensors of the resident payload (an
    op reading one of them is a corpus read), ``device`` where the step
    runs: on CUDA the peak is the allocator's, else the largest tensor."""
    dev = torch.device(device) if device is not None else None
    cuda = dev is not None and dev.type == "cuda"
    rec = Recorder(corpus if spec.corpus_dtype == "s8" else (),
                   spec.corpus_elems)
    if cuda:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with rec:
        run()
    if cuda:
        torch.cuda.synchronize(dev)
    peak = (float(torch.cuda.max_memory_allocated(dev) - base) if cuda
            else float(rec.largest))
    reads = Counter(site for site, _, _ in rec.reads)

    in_trip = [d for _, d, trip in rec.reads if trip]
    if in_trip:
        raise AuditError("hlo-host-sync", label,
                         "host read inside a trip function "
                         f"({'/'.join(TRIP_FUNCTIONS)})", in_trip)
    bad = [d for site, d, _ in rec.reads
           if site not in spec.allowed_reads]
    over = [f"{site}: {n} reads, allowed {spec.allowed_reads[site]}"
            for site, n in reads.items()
            if site in spec.allowed_reads
            and spec.allowed_reads[site] is not None
            and n > spec.allowed_reads[site]]
    if bad or over:
        raise AuditError("hlo-host-sync", label,
                         "host read outside the allowed sites "
                         f"{sorted(spec.allowed_reads)}", bad + over)
    if rec.f64:
        raise AuditError("hlo-f64", label,
                         "f64/c128 buffer in a bf16/f32 pipeline", rec.f64)
    ins = operand_tensors(operands)
    elems = spec.corpus_elems
    if spec.corpus_dtype in ("bf16", "f16") and elems > 0:
        bad = [f"operand f32 {tuple(t.shape)}" for t in ins
               if t.dtype == torch.float32 and t.numel() >= elems]
        if bad:
            raise AuditError(
                "hlo-corpus-promotion", label,
                f"{spec.corpus_dtype} corpus ({elems} elems) enters the "
                "step as a corpus-sized f32 operand", bad)
    if spec.corpus_dtype == "s8" and elems > 0:
        widened = [f"operand {t.dtype} {tuple(t.shape)}" for t in ins
                   if t.dtype in (torch.float32, torch.bfloat16)
                   and t.numel() >= elems]
        widened += rec.widened
        if widened:
            raise AuditError(
                "hlo-int8-residency", label,
                f"quantized corpus ({elems} payload elems) made whole in "
                "f32/bf16 - dequantized outside the kernels", widened)
        if not any(t.dtype == torch.int8 and t.numel() >= elems
                   for t in ins):
            raise AuditError(
                "hlo-int8-residency", label,
                f"quantized corpus ({elems} payload elems) has no "
                "corpus-sized int8 operand - the compressed payload did "
                "not reach the step at int8")
    total = sum(rec.collective.values())
    if spec.collective_budget is not None and total > spec.collective_budget:
        raise AuditError(
            "hlo-collective-budget", label,
            f"cross-shard traffic {total} B exceeds the budget "
            f"{spec.collective_budget} B",
            [f"{k}: {v} B" for k, v in sorted(rec.collective.items())])
    report = AuditReport(label=label, collective_total=total,
                         collective=dict(rec.collective), peak_bytes=peak,
                         host_reads=dict(reads), trips=rec.trips,
                         ops=rec.ops)
    if spec.peak_bytes is not None and peak > spec.peak_bytes:
        raise AuditError(
            "hlo-peak-buffer", label,
            f"peak {peak:.0f} B ({'allocator' if cuda else 'largest tensor'})"
            f" exceeds the declared bound {spec.peak_bytes} B")
    return report
