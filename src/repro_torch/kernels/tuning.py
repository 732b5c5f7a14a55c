"""Shape-bucket launch-shape autotuning for the CUDA kernel ops (port of
``repro.kernels.tuning``).

The CUDA kernels take their launch shape as an argument: the dense body's
docs per block (``block_n``, ``csrc/maxsim.cu``) and the reveal body's
valid tokens per staged chunk (``block_l``, ``csrc/reveal.cu``: 64 is the
256-thread shape, 32 the 128-thread one). No cell depends on either: every
cell is one sequential ``fmaf`` chain over m from 0.f, so every candidate
gives bit-identical outputs and a choice is a pure speed knob. This module
keeps a small table:

    (op, shape bucket) -> {knob: int, ...}

* **Buckets**, not exact shapes: every dimension is rounded up to its next
  power of two, so one timed entry covers the family of shapes the serving
  engine's static buckets generate. The keys are the JAX package's (the
  dims ``repro_torch.kernels.ops.launch_dims`` derives from a launch).
* **Resolution order** (``repro_torch.kernels.ops._resolve``): an explicit
  argument wins, then a tuned table entry, then the per-op default below.
  The defaults are the launches made before tuning existed.
* **Persistence**: :func:`save_table` / :func:`load_table` round-trip the
  table through JSON (``EngineConfig.tuning_table``). A knob the port does
  not have (a JAX table's ``block_t`` / ``block_b``) raises ValueError: a
  table is never loaded in part or in silence.

:func:`autotune` times a caller-supplied runner over :func:`candidates` and
records the winner; :func:`time_call` times the card's work with CUDA
events (by the host clock for a runner on the CPU). The runners that
build synthetic tensors per op live in ``repro_torch.kernels.ops.
autotune_op`` (ops imports this module, not the other way around).
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.kernels.gather_maxsim import BLOCK_L
from repro_torch.kernels.maxsim import BLOCK_N

# Per-op default: today's launches. block_n 2 is the dense kernel's docs
# per block before tuning; block_l 0 keeps the reveal kernel's rule by
# launch size (64 up to 512 frontier rows, 32 above).
DEFAULTS: Dict[str, Dict[str, int]] = {
    "maxsim": {"block_n": 2},
    "maxsim_batch": {"block_n": 2},
    "gather_maxsim": {"block_l": 0},
    "fused_reveal": {"block_l": 0},
}

# The values each knob may take in a table entry: the shapes the kernels
# are built for (block_l 0: the rule by frontier rows).
KNOB_VALUES: Dict[str, Tuple[int, ...]] = {
    "block_n": BLOCK_N,
    "block_l": (0, *BLOCK_L),
}

# Candidate grids per op: every shape the kernels are built for. Candidates
# are clamped to the launch dims and deduped (a block of more docs than N
# launches as the smallest that covers N), so a bucket times each distinct
# launch once.
CANDIDATES: Dict[str, List[Dict[str, int]]] = {
    "maxsim": [{"block_n": n} for n in BLOCK_N],
    "maxsim_batch": [{"block_n": n} for n in BLOCK_N],
    "gather_maxsim": [{"block_l": n} for n in BLOCK_L],
    "fused_reveal": [{"block_l": n} for n in BLOCK_L],
}

# Cycles of the spin kernel that keeps the card busy while the host
# enqueues a timed call (~2 ms on an H100), far above a wrapper's host time.
_SPIN_CYCLES = 4_000_000

_TABLE: Dict[Tuple, Dict[str, int]] = {}


def _pow2_bucket(x: int) -> int:
    x = max(int(x), 1)
    return 1 << (x - 1).bit_length()


def bucket_key(op: str, dims: Dict[str, int]) -> Tuple:
    """(op, ((dim, pow2-rounded size), ...)) — the table's lookup key."""
    return (op, tuple(sorted((k, _pow2_bucket(v)) for k, v in dims.items())))


def lookup(op: str, dims: Dict[str, int]) -> Dict[str, int]:
    """Tuned entry for the op at these dims, merged over its defaults."""
    cfg = dict(DEFAULTS.get(op, {}))
    cfg.update(_TABLE.get(bucket_key(op, dims), {}))
    return cfg


def check_config(op: str, config: Dict[str, Any]) -> Dict[str, int]:
    """``config`` as {knob: int}; ValueError on an op the table does not
    tune, a knob the op does not have, or a value its kernel is not built
    for."""
    if op not in DEFAULTS:
        raise ValueError(f"tuning: unknown op {op!r} (tuned ops: "
                         f"{sorted(DEFAULTS)})")
    out = {}
    for k, v in config.items():
        if k not in DEFAULTS[op]:
            raise ValueError(
                f"tuning: {op!r} has no knob {k!r} (its knobs: "
                f"{sorted(DEFAULTS[op])}); a table from another kernel "
                "family does not load")
        if int(v) not in KNOB_VALUES[k]:
            raise ValueError(f"tuning: {op}.{k}={v!r} is not one of "
                             f"{KNOB_VALUES[k]}")
        out[k] = int(v)
    return out


def record(op: str, dims: Dict[str, int], config: Dict[str, int]) -> None:
    _TABLE[bucket_key(op, dims)] = check_config(op, config)


def table() -> Dict[Tuple, Dict[str, int]]:
    return dict(_TABLE)


def clear() -> None:
    _TABLE.clear()


def table_json(keys: Optional[set] = None) -> List[Dict[str, Any]]:
    """The table as JSON-ready rows (also what ``save_table`` writes).
    ``keys`` restricts to those bucket keys (the serving engine persists
    only its own buckets out of the process-shared cache)."""
    return [{"op": op, "bucket": dict(bucket), "config": dict(cfg)}
            for (op, bucket), cfg in sorted(_TABLE.items())
            if keys is None or (op, bucket) in keys]


def save_table(path: str, *, keys: Optional[set] = None) -> None:
    with open(path, "w") as f:
        json.dump(table_json(keys), f, indent=1)


def load_table(path: str) -> int:
    """Merge a persisted table into the live one; returns entries loaded.
    Every row is checked before any is merged, so a table with a foreign
    knob raises ValueError and leaves the live table as it was."""
    with open(path) as f:
        rows = json.load(f)
    parsed = []
    for row in rows:
        key = (row["op"], tuple(sorted(
            (k, int(v)) for k, v in row["bucket"].items())))
        parsed.append((key, check_config(row["op"], row["config"])))
    _TABLE.update(parsed)
    return len(rows)


def candidates(op: str, dims: Dict[str, int]) -> List[Dict[str, int]]:
    """The op's candidate grid, clamped to the launch dims and deduped.

    Clamping mirrors the launch: a dense block of more docs than N covers
    the same docs as one of N, rounded up to a shape the kernel is built
    for; two candidates that collapse to the same launch are timed once.
    """
    n = dims.get("N")
    out: List[Dict[str, int]] = []
    for cand in CANDIDATES.get(op, [DEFAULTS.get(op, {})]):
        eff = dict(cand)
        if n and eff.get("block_n", 0) > n:
            eff["block_n"] = min(v for v in KNOB_VALUES["block_n"] if v >= n)
        if eff not in out:
            out.append(eff)
    return out


def time_call(fn: Callable[[], Any], *, repeats: int = 3,
              device=None) -> float:
    """Best-of-N seconds of ``fn`` (a first untimed call builds and warms).
    On a CUDA ``device`` each call is timed between two CUDA events on the
    current stream behind a spin kernel, which keeps the card busy while
    the host enqueues the events and the call: the window holds the
    device's time for the call, not the host's; otherwise by the host
    clock around the call."""
    cuda = device is not None and torch.device(device).type == "cuda"
    fn()
    best = float("inf")
    for _ in range(max(repeats, 1)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_SPIN_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def autotune(op: str, dims: Dict[str, int],
             runner: Callable[..., Callable[[], Any]], *,
             repeats: int = 3,
             cands: Optional[Iterable[Dict[str, int]]] = None,
             device=None,
             ) -> Tuple[Dict[str, int], Dict[str, float]]:
    """Time ``runner(**candidate)`` over the candidate grid, record the
    winner for (op, dims), and return (best_config, per-candidate seconds).

    ``runner`` is called once per candidate and must return a 0-arg
    callable launching the op at that configuration; ``device`` is where
    it runs (CUDA: timed by events, see :func:`time_call`).
    """
    timings: Dict[str, float] = {}
    best_cfg: Optional[Dict[str, int]] = None
    best_t = float("inf")
    for cand in (cands if cands is not None else candidates(op, dims)):
        t = time_call(runner(**cand), repeats=repeats, device=device)
        timings[json.dumps(cand, sort_keys=True)] = t
        if t < best_t:
            best_t, best_cfg = t, dict(cand)
    if best_cfg is None:
        raise ValueError(f"autotune({op!r}): empty candidate set")
    record(op, dims, best_cfg)
    return best_cfg, timings
