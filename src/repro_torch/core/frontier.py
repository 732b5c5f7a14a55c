"""Pooled cross-query reveal engine (port of ``repro.core.frontier``).

One global loop drives all Q queries of a batch at once:

  1. every trip, each still-active query runs the shared LUCB block
     selection (``core.batched._round_select``),
  2. the selected (doc, token) blocks of all queries are pooled into one
     frontier: doc ids are query-offset into the Q*N stacked candidate
     slots (the cell source reads each slot's doc where it lies), token ids
     into the stacked (Q*T, M) token table,
  3. the whole frontier goes through ONE reveal launch per trip,
  4. per-query done-masks retire finished queries (their slots drop out,
     their round counters freeze); with ``cfg.max_block_docs`` /
     ``max_block_tokens`` above the solo widths the freed capacity widens
     the survivors' blocks.

Two round bodies lower step 3:

* **fused** (the serving default): one ``fused_reveal`` launch returns
  the cell values and each row's statistic deltas; the state update is one
  scatter-min into a sentinel-encoded (Q*N, T) cell table (``_UNREV``
  marks unrevealed) and one 3-column scatter-add of (n, total, total_sq).
* **chain** (the oracle): cells from ``compute_cells`` (the
  ``gather_maxsim`` kernel in serving), state updated by
  ``_apply_block_reveal`` over a stacked ``BanditState``.

Both make identical per-query decisions from identical statistics, and
their statistics are summed in one order, so they agree bit for bit.

Streaming (continuous batching): a :class:`FrontierState` is the packed
per-slot carry both bodies read and write at the call boundary, so a run
can pause after ``trip_limit`` trips, return its state, and resume under
either body; ``fresh`` slots are re-initialised from the call's inputs
while carried slots pass through. The JAX package's per-query PRNG keys
are per-slot draw states in the carry (``core.draws``): a slot's draws
depend only on its seed and its own trip count, so a resumed or refilled
stream replays the one-shot run. ``alpha_scale`` / ``round_cap`` are the
per-call fidelity knobs and ``prereveal`` seeds cells known from stage 1,
as in JAX.

Each trip is a function of tensors to tensors with no host read; the loop
reads one flag from the device per trip (its continue test).

Trip graphs (:class:`TripGraphs`): on the card a fused one-shot run may
launch its trips as one CUDA graph a batch shape, captured at the first
trip of a run made while the cache is armed (the serving engine's
warm-up) and replayed for every trip of every later run of that shape.
Every tensor the trip reads then lives in a static buffer of the graph
(:meth:`TripGraph.stage`), each run copies its values in before the init
reveal, and a replay writes the new state back into the buffers it reads.
The trip body, the continue test and so the trips, rounds and statistics
are the eager run's; only the launch differs.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch import spans
from repro_torch.core import bounds as B
from repro_torch.core.bandit import _select_arms, _topk_mask
from repro_torch.core.batched import (BatchedConfig, CellFn,
                                      _apply_block_reveal, _max_rounds,
                                      _round_select)
from repro_torch.core.draws import DRAW_WIDTH, TORCH_DRAWS, DrawSource
from repro_torch.core.state import BanditState
from repro_torch.kernels import _build
from repro_torch.kernels.reveal import reveal_stats

_NEG = -3e38
# Fused-round cell table sentinel: unrevealed cells hold _UNREV; anything
# below _REV_THRESH is a revealed value.
_UNREV = 3e38
_REV_THRESH = 1.5e38
# Finite-score guard: a revealed cell that comes back NaN/Inf is recorded
# as _QUAR — finite, so the statistics stay well-defined, yet far below any
# genuine MaxSim value, so the doc can never win the top-K. _QUAR_THRESH
# separates quarantined cells from real ones at finalize time.
_QUAR = -3e4
_QUAR_THRESH = -1e4


class FrontierState(NamedTuple):
    """Resumable pooled-frontier carry, per slot. The statistics are one
    sentinel-encoded cell table and one packed (n, total, total_sq) block;
    ``draw``/``rounds``/``done`` are per slot. When slot q retires the
    host harvests it and refills it with ``fresh[q]=True`` on the next
    call; every other slot's rows pass through untouched."""

    cellvals: torch.Tensor   # (Q*N, T) f32 — _UNREV where unrevealed
    stats: torch.Tensor      # (Q*N, 3) f32 — [n, total, total_sq]
    draw: torch.Tensor       # (Q, 2) i64 — per-slot draw state
    rounds: torch.Tensor     # (Q,) i64 — frozen at retirement
    done: torch.Tensor       # (Q,) bool


def init_frontier_state(Q: int, N: int, T: int, *,
                        device="cuda") -> FrontierState:
    """An all-slots-empty carry: every slot retired, zero statistics, cells
    reading as revealed-empty. Slots come alive when refilled via
    ``fresh``."""
    dev = torch.device(device)
    return FrontierState(
        cellvals=torch.zeros((Q * N, T), dtype=torch.float32, device=dev),
        stats=torch.zeros((Q * N, 3), dtype=torch.float32, device=dev),
        draw=torch.zeros((Q, DRAW_WIDTH), dtype=torch.int64, device=dev),
        rounds=torch.zeros((Q,), dtype=torch.int64, device=dev),
        done=torch.ones((Q,), dtype=torch.bool, device=dev))


class PooledResult(NamedTuple):
    topk: torch.Tensor            # (Q, K) i64 — per-query top-K doc slots
    s_hat: torch.Tensor           # (Q, N) f32 — final score estimates
    coverage: torch.Tensor        # (Q,) f32 — Eq. 6 per query
    reveals: torch.Tensor         # (Q,) i64 — |Omega_q|
    rounds: torch.Tensor          # (Q,) i64 — per-query LUCB rounds
    separated: torch.Tensor       # (Q,) bool — stopped via LCB >= UCB
    revealed: torch.Tensor        # (Q, N, T) bool — final observation sets
    trips: torch.Tensor           # () i64 — global loop iterations
    total_rounds: torch.Tensor    # () i64 — sum(rounds)
    lockstep_waste: torch.Tensor  # () i64 — Q*trips - total_rounds
    occupancy: torch.Tensor       # () f32 — mean live share of frontier slots
    quarantined: torch.Tensor     # (Q,) i64 — docs with a non-finite cell


def _with_stats(compute_cells: CellFn) -> Callable:
    """Adapt a plain gather-style cell source to the fused-round contract
    (values plus per-row statistic deltas over ``new_mask``)."""

    def cells_fused(flat_doc, flat_tok, new_mask):
        v = compute_cells(flat_doc, flat_tok)
        return v, reveal_stats(v, new_mask)

    return cells_fused


def _sanitize(vals: torch.Tensor) -> torch.Tensor:
    """Finite-score guard: identity on finite data, _QUAR where poisoned."""
    return torch.where(torch.isfinite(vals), vals, _QUAR)


def _guarded_stats(vals, new, dstats):
    """Sanitize freshly revealed values and rebuild the statistic deltas of
    rows where a non-finite value reached the kernel's sums; rows with only
    finite cells keep the kernel's stats bit for bit."""
    bad = new & ~torch.isfinite(vals)
    vals = _sanitize(vals)
    vm = torch.where(new, vals, 0.0)
    fix = torch.stack([new.to(torch.float32).sum(-1), vm.sum(-1),
                       (vm * vm).sum(-1)], dim=-1)
    return vals, torch.where(bad.any(-1, keepdim=True), fix, dstats)


def _scatter_min(table: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    R, T = table.shape
    lin = (rows.unsqueeze(-1) * T + cols).reshape(-1)
    return table.reshape(-1).scatter_reduce(
        0, lin, src.reshape(-1), "amin").reshape(R, T)


def _rows_to(table: torch.Tensor, dump: torch.Tensor,
             rows: torch.Tensor) -> torch.Tensor:
    """Scatter ``rows`` into ``table`` at row indices ``dump``."""
    return table.scatter(0, dump[:, None].expand_as(rows), rows)


def _knob(x, dtype) -> torch.Tensor:
    """A per-call knob as a 0-d tensor: a Python number becomes a CPU
    scalar (an operand that costs no launch), a 0-d tensor stays on its
    device."""
    return torch.as_tensor(x, dtype=dtype)


def _profiled() -> bool:
    """Whether torch's profiler is on: set before it starts tracing the
    device and cleared once it has stopped."""
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False))


def as_is(name: str, x: torch.Tensor) -> torch.Tensor:
    """The staging of a run without a trip graph: the operand itself."""
    del name
    return x


class TripGraph:
    """The fused trip of one batch shape as a CUDA graph over static
    buffers. A run holding :attr:`lock` stages every tensor its trip reads
    (:meth:`stage`), then loops over :meth:`bind`'s trip, whose first call
    in the first run captures the run's ``fused_trip`` and whose every call
    replays it. Off the card (a ``TripGraphs(stand_in=True)`` cache) the
    "replay" calls that first run's trip eagerly on the same buffers,
    which holds the CPU to what the graph reads: values staged by the
    current run, and nothing else that changes between runs.

    While torch's profiler is on, a trip on the card runs that same eager
    call in place of the replay: CUPTI's device tracing deadlocks the
    profiler's stop against a graph launched on another thread."""

    def __init__(self, device: torch.device):
        self.lock = threading.Lock()
        self.device = device
        self.replays = 0     # trips served by a replay
        self._bufs: Dict[str, torch.Tensor] = {}
        self._state: Optional[FrontierState] = None
        self._occ: Optional[torch.Tensor] = None
        self._replay: Optional[Callable[[], None]] = None
        self._eager: Optional[Callable[[], None]] = None
        self._launches: Dict[str, int] = {}

    @property
    def ready(self) -> bool:
        """Whether the trip has been captured."""
        return self._replay is not None

    def stage(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The static buffer ``name`` holding ``x``: made by the first run,
        copied into by every run (one launch)."""
        buf = self._bufs.get(name)
        if buf is None:
            buf = self._bufs[name] = torch.empty_like(
                x, memory_format=torch.contiguous_format)
        elif buf.shape != x.shape or buf.dtype != x.dtype:
            raise ValueError(f"trip graph operand {name!r}: "
                             f"{tuple(x.shape)} {x.dtype} where the graph "
                             f"holds {tuple(buf.shape)} {buf.dtype}")
        return buf.copy_(x)

    def bind(self, trip: Callable, state: FrontierState):
        """(the loop's trip, its first state): ``state`` staged, and a trip
        that stages the active mask and replays the graph (capturing
        ``trip`` first where none is captured yet), returning the static
        state and occupancy. Each replay adds the launches it holds to
        ``kernels._build.LAUNCHES`` and one to :attr:`replays`; under the
        profiler the trip runs eagerly on the same buffers (see the
        class)."""
        self._state = FrontierState(*(
            self.stage(f"state.{f}", x)
            for f, x in zip(FrontierState._fields, state)))

        def replayed(st: FrontierState, active: torch.Tensor):
            del st
            active = self.stage("active", active)
            if self._replay is None:
                self._capture(trip, active)
            if _profiled():
                self._eager()
            else:
                self._replay()
                _build.add_launches(self._launches)
                self.replays += 1
            return self._state, self._occ

        return replayed, self._state

    def release(self, state: FrontierState) -> FrontierState:
        """A loop's final state as fresh tensors: the static buffers are
        the next run's, and a pipelined batch is read after it starts."""
        return FrontierState(*(x.clone() for x in state))

    def _capture(self, trip: Callable, active: torch.Tensor) -> None:
        st = self._state
        self._occ = torch.zeros((), dtype=torch.float32, device=self.device)
        occ_buf = self._occ

        def eager():
            nxt, occ = trip(st, active)
            for dst, src in zip(st, nxt):
                dst.copy_(src)
            occ_buf.copy_(occ)

        self._eager = eager
        if self.device.type != "cuda":
            self._replay = eager
            return
        # One eager trip on the capture stream first, so what a first call
        # makes and keeps (cached index tensors, the kernels' libraries) is
        # made outside the capture; its outputs are dropped.
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            trip(st, active)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = _build.launch_counts()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            nxt, occ = trip(st, active)
            for dst, src in zip(st, nxt):
                dst.copy_(src)
            occ_buf.copy_(occ)
        after = _build.launch_counts()
        self._launches = {k: n - before[k] for k, n in after.items()
                          if n != before[k]}
        # A capture launches nothing: its counts come back at each replay.
        _build.add_launches(self._launches, -1)
        self._replay = graph.replay


class TripGraphs:
    """One step's trip graphs, by batch shape key. :meth:`use` hands a run
    the key's graph, locked (one run at a time on its buffers), where the
    run is on the card (or ``stand_in``), no dispatch mode records it (an
    audit or a FLOP count sees the eager ops), and the key's trip has been
    captured, or the cache is armed (:meth:`capturing`), which makes and
    captures it at the run's first trip. Every other run gets None and
    runs its trips eagerly."""

    def __init__(self, *, stand_in: bool = False):
        self._graphs: Dict[tuple, TripGraph] = {}
        self._lock = threading.Lock()
        self._armed = False
        self._stand_in = stand_in

    @contextlib.contextmanager
    def capturing(self):
        """Arm capture for the runs made inside (on one thread, while no
        other thread launches on the card)."""
        self._armed = True
        try:
            yield self
        finally:
            self._armed = False

    def captured(self) -> list:
        """The keys whose trip has been captured."""
        with self._lock:
            return [k for k, g in self._graphs.items() if g.ready]

    @contextlib.contextmanager
    def use(self, key: tuple, device: torch.device):
        """The graph a run of ``key`` on ``device`` launches its trips
        through, held under its lock, or None (see the class)."""
        graph = None
        if ((device.type == "cuda" or self._stand_in)
                and _get_current_dispatch_mode() is None):
            with self._lock:
                graph = self._graphs.get(key)
                if graph is None and self._armed:
                    graph = self._graphs[key] = TripGraph(device)
            if graph is not None and not (graph.ready or self._armed):
                graph = None
        if graph is None:
            yield None
            return
        with graph.lock:
            yield graph


def run_pooled_bandit(
    compute_cells: CellFn,
    a: torch.Tensor,                # (Q, N, T) lower support per cell
    b: torch.Tensor,                # (Q, N, T) upper support per cell
    seeds: torch.Tensor,            # (Q, ...) per-query seeds of ``draws``
    cfg: BatchedConfig,
    *,
    draws: Optional[DrawSource] = None,      # default TorchDraws
    doc_mask: Optional[torch.Tensor] = None,   # (Q, N) bool valid candidates
    compute_cells_fused: Optional[Callable] = None,  # derived when omitted
    fused: bool = True,
    prereveal: Optional[torch.Tensor] = None,       # (Q, N, T) bool known
    prereveal_vals: Optional[torch.Tensor] = None,  # (Q, N, T) their values
    carry: Optional[FrontierState] = None,   # resume from a prior slice
    fresh: Optional[torch.Tensor] = None,    # (Q,) bool slots to (re)init
    trip_limit: int = 0,                     # > 0: pause after this many
    return_state: bool = False,
    alpha_scale=None,                        # () f32 >= 1: fidelity knob
    round_cap=None,                          # () int: round cap (<= 0 off)
    graph: Optional[TripGraph] = None,       # held: launch trips through it
):
    """Run the pooled bandit and return per-query results.

    ``compute_cells(flat_doc (S,), flat_tok (S, G)) -> (S, G)`` reveals
    cells of the stacked axes (doc q*N+i pairs only with tokens q*T+t of
    the same query); ``compute_cells_fused(flat_doc, flat_tok, new_mask)
    -> (vals (S, G), stats (S, 3))`` is the fused contract.

    ``prereveal``/``prereveal_vals`` seed the bandit with cells whose exact
    values an earlier stage computed (stage-1 hits, Eq. 15): they enter
    the statistics before round 0 at zero reveal cost and are never
    re-revealed; non-finite seeds are quarantined like revealed cells.

    Streaming: ``carry`` resumes from a prior call's :class:`FrontierState`;
    ``fresh`` (default all-False with a carry, forced all-True without)
    marks the slots re-initialised from this call's ``a``/``b``/``seeds``/
    ``prereveal`` (init reveal included, prereveal masked to fresh slots),
    while carried slots' statistics, draws, rounds and ``done`` pass
    through. Carried slots' inputs must be re-presented unchanged.
    ``trip_limit > 0`` pauses after that many trips; a slot's results are
    final once its ``done`` is set. ``return_state=True`` returns
    ``(PooledResult, FrontierState)``.

    Fidelity knobs (Python numbers or 0-d tensors on the run's device):
    ``alpha_scale`` multiplies ``alpha_ef`` (``1.0`` is bit-identical to
    ``None``); ``round_cap > 0`` caps the rounds at ``min(max_rounds,
    round_cap)``.

    Finite-score guard (always on): a revealed cell that comes back
    non-finite is recorded as ``_QUAR``; its doc is excluded from the
    final top-K and counted in ``PooledResult.quarantined``.

    ``graph`` (a :class:`TripGraph` whose lock the caller holds; fused
    one-shot runs only) stages every operand the trip reads into the
    graph's buffers and replays the captured trip in place of each eager
    one; ``compute_cells_fused`` must then read staged operands too.
    """
    if graph is not None and not (fused and carry is None
                                  and trip_limit <= 0 and not return_state):
        raise ValueError("a trip graph runs the fused one-shot body only")
    stage = as_is if graph is None else graph.stage
    draws = draws or TORCH_DRAWS
    Q, N, T = a.shape
    dev = a.device
    if carry is None:
        fresh = torch.ones((Q,), dtype=torch.bool, device=dev)
    elif fresh is None:
        fresh = torch.zeros((Q,), dtype=torch.bool, device=dev)
    fresh = fresh.to(device=dev, dtype=torch.bool)
    fresh_rows = fresh.repeat_interleave(N)                     # (Q*N,)
    k = cfg.k
    G = cfg.block_tokens
    half = max(cfg.block_docs // 2, 1)
    # Selection widths per query: fixed (== solo) unless growth is enabled,
    # clamped to N / T.
    half_w = min(max(cfg.max_block_docs // 2, half), max(N, 1))
    W = 2 * half_w                           # per-query selection rows
    G_cap = min(max(cfg.max_block_tokens, G), max(T, 1))  # token sel width
    F = Q * 2 * half                         # frontier capacity (slots)
    max_rounds = _max_rounds(cfg, N, T)
    if round_cap is not None:
        rc = _knob(round_cap, torch.int64)
        max_rounds = torch.where(rc > 0, torch.clamp(rc, max=max_rounds),
                                 max_rounds)
    if doc_mask is None:
        doc_mask = torch.ones((Q, N), dtype=torch.bool, device=dev)
    # Everything a trip reads is staged (a trip graph's buffers, else the
    # tensors themselves).
    doc_mask = stage("doc_mask", doc_mask)
    a = stage("a", torch.where(doc_mask[:, :, None], a, 0.0).to(
        torch.float32))
    b = stage("b", torch.where(doc_mask[:, :, None], b, 0.0).to(
        torch.float32))

    pr_flat = pv_flat = None
    if prereveal is not None:
        pr_flat = (prereveal & doc_mask[:, :, None]).reshape(Q * N, T)
        if carry is not None:
            # Seeds belong to the query entering a slot; a carried slot
            # absorbed its own at its fresh call.
            pr_flat = pr_flat & fresh_rows[:, None]
        pv_flat = torch.where(pr_flat, prereveal_vals.reshape(Q * N, T).to(
            torch.float32), 0.0)
        pv_flat = _sanitize(pv_flat)

    q_doc_off = stage("q_doc_off",
                      (torch.arange(Q, device=dev) * N)[:, None])  # (Q, 1)
    tok_off = stage("tok_off",
                    (torch.arange(Q * N, device=dev) // N * T)[:, None])

    # Per-slot draw state and the init reveal's token per candidate (paper
    # footnote 2: one random cell per doc, all queries in one reveal).
    draw0, t0 = draws.init(seeds.to(dev), fresh,
                           None if carry is None else carry.draw, N, T)
    all_docs = torch.arange(Q * N, device=dev)
    flat_t0 = t0.to(device=dev, dtype=torch.int64).reshape(Q * N, 1)

    # serfling_radius is linear in alpha_ef, so the scale is exact; a scale
    # of 1.0 (no knob) is an IEEE identity.
    alpha_ef = B._f32(cfg.alpha_ef) * _knob(
        1.0 if alpha_scale is None else alpha_scale, torch.float32)
    iv_kwargs = dict(T=T, N=N, delta=cfg.delta, alpha_ef=alpha_ef,
                     c=cfg.radius_c, bias_kappa=cfg.bias_kappa)

    def get_intervals(n_q, total_q, total_sq_q, revealed_q) -> B.Intervals:
        iv = B.intervals(n_q, total_q, total_sq_q, revealed_q, a, b,
                         **iv_kwargs)
        return iv._replace(
            s_hat=torch.where(doc_mask, iv.s_hat, _NEG),
            lcb=torch.where(doc_mask, iv.lcb, _NEG),
            ucb=torch.where(doc_mask, iv.ucb, _NEG))

    select = functools.partial(_round_select, k=k, epsilon=cfg.epsilon,
                               half=half_w, G=G_cap)

    def select_round(draw, iv, revealed_q, n_q, active, *, compact):
        """Shared round front-end: every slot's draws, per-query LUCB
        selection, capacity allotment over both growth axes, and frontier
        pooling."""
        draw, explore_u, gumbel = draws.round(draw, W, T)
        sel = select(explore_u.to(dev), gumbel.to(dev), iv, revealed_q, n_q,
                     a, b, doc_mask)

        # Capacity allotment: freed DOC slots are split evenly among active
        # queries (never below the solo width, never above the selection
        # width); remaining CELL capacity (F*G cells per round) widens each
        # surviving slot's token block.
        n_active = torch.clamp(active.sum(), min=1)
        per_group = torch.clamp(F // (2 * n_active), half, half_w)
        per_tok = torch.clamp((F * G) // (n_active * 2 * per_group), G, G_cap)
        grp_en = torch.arange(half_w, device=dev) < per_group
        doc_en = torch.cat([grp_en, grp_en])                    # (W,)
        tok_en = torch.arange(G_cap, device=dev) < per_tok      # (G_cap,)

        live = active & ~sel.stop                               # (Q,)
        sel_en = sel.cell_ok & doc_en[None, :, None] & tok_en[None, None, :]
        cell_en = sel_en & live[:, None, None]
        no_progress = ~sel_en.any(dim=2).any(dim=1)

        flat_doc = (sel.doc_idx + q_doc_off).reshape(Q * W)
        flat_tok = sel.tok_idx.reshape(Q * W, G_cap)
        flat_cell = cell_en.reshape(Q * W, G_cap)
        slot_live = flat_cell.any(dim=-1)                       # (Q*W,)
        if compact:
            # Pool + compact: live slots go to the frontier front; slot F is
            # a dump row that is cut off, so retired queries' slots vanish.
            pos = torch.cumsum(slot_live.to(torch.int64), 0) - 1
            dump = torch.where(slot_live & (pos < F), pos, F)
            f_doc = torch.zeros((F + 1,), dtype=torch.int64, device=dev)
            f_doc = f_doc.scatter(0, dump, flat_doc)[:F]
            f_tok = _rows_to(torch.zeros((F + 1, G_cap), dtype=torch.int64,
                                         device=dev), dump, flat_tok)[:F]
            f_cell = _rows_to(torch.zeros((F + 1, G_cap), dtype=torch.bool,
                                          device=dev), dump, flat_cell)[:F]
        else:
            # No growth => capacity == selection width: the flat selections
            # feed the launch directly (dead slots are masked no-ops).
            f_doc, f_tok, f_cell = flat_doc, flat_tok, flat_cell
        occ = slot_live.to(torch.float32).sum() / float(F)
        return draw, sel, f_doc, f_tok, f_cell, no_progress, occ

    def finalize(n, total, total_sq, revealed, rounds, trips, occ_sum,
                 quar_doc) -> PooledResult:
        iv = get_intervals(n.reshape(Q, N), total.reshape(Q, N),
                           total_sq.reshape(Q, N), revealed.reshape(Q, N, T))
        # Quarantined docs are forced out of the top-K.
        quar_q = quar_doc.reshape(Q, N) & doc_mask
        iv = iv._replace(s_hat=torch.where(quar_q, _NEG, iv.s_hat))
        tk_mask, topk_idx = _topk_mask(iv.s_hat, k)
        i_plus, i_minus = _select_arms(iv, tk_mask, doc_mask)
        separated = (torch.gather(iv.lcb, 1, i_plus[:, None])
                     >= torch.gather(iv.ucb, 1, i_minus[:, None]))[:, 0]
        rev_q = revealed.reshape(Q, N, T) & doc_mask[:, :, None]
        n_rev = rev_q.sum(dim=(1, 2))
        n_cells = torch.clamp(doc_mask.sum(dim=1) * T, min=1)
        total_rounds = rounds.sum()
        trips_t = torch.tensor(trips, dtype=torch.int64, device=dev)
        return PooledResult(
            topk=topk_idx,
            s_hat=iv.s_hat,
            coverage=n_rev.to(torch.float32) / n_cells.to(torch.float32),
            reveals=n_rev,
            rounds=rounds,
            separated=separated,
            revealed=rev_q,
            trips=trips_t,
            total_rounds=total_rounds,
            # Clamped: on a resumed slice, carried-in rounds can exceed
            # this slice's Q*trips.
            lockstep_waste=torch.clamp(Q * trips_t - total_rounds, min=0),
            occupancy=occ_sum / max(float(trips), 1.0),
            quarantined=quar_q.sum(dim=1),
        )

    def run_loop(trip, state, trip_rows: int):
        """Trips until no slot is active or ``trip_limit`` is reached: one
        host read per trip (the continue test), none inside ``trip``.
        Adds its trips, host reads, the ns blocked in them, its own ns,
        the frontier rows the reveal launches staged (the init launch's
        Q*N, ``trip_rows`` a trip) and the trips that replayed ``graph``
        (where ``trip`` is its bound trip) to the calling
        thread's open batch stamps (``repro_torch.spans``), where one is
        open."""
        stamps = spans.open_stamps()
        now = spans.now_ns
        trips = 0
        reads = wait_ns = 0
        occ_sum = torch.zeros((), dtype=torch.float32, device=dev)
        replays0 = graph.replays if graph is not None else 0
        t_loop = now()
        while trip_limit <= 0 or trips < trip_limit:
            active = ~state.done & (state.rounds < max_rounds)
            t = now()
            go = bool(active.any())
            wait_ns += now() - t
            reads += 1
            if not go:
                break
            state, occ = trip(state, active)
            occ_sum = occ_sum + occ
            trips += 1
        if stamps is not None:
            stamps[spans.TRIPS] += trips
            stamps[spans.READS] += reads
            stamps[spans.WAIT_NS] += wait_ns
            stamps[spans.LOOP_NS] += now() - t_loop
            stamps[spans.REVEAL_ROWS] += Q * N + trips * trip_rows
            stamps[spans.GRAPH_TRIPS] += (graph.replays - replays0
                                          if graph is not None else 0)
        return state, trips, occ_sum

    # Queries with NO valid candidate start retired (rounds stay 0).
    done0 = ~doc_mask.any(dim=1)
    rounds0 = torch.zeros((Q,), dtype=torch.int64, device=dev)
    if carry is not None:
        done0 = torch.where(fresh, done0, carry.done)
        rounds0 = torch.where(fresh, rounds0, carry.rounds)

    if fused:
        cells_fused = (compute_cells_fused if compute_cells_fused is not None
                       else _with_stats(compute_cells))
        flat_mask = doc_mask.reshape(Q * N)
        new0 = flat_mask[:, None]                               # (Q*N, 1)
        if carry is not None:
            new0 = new0 & fresh_rows[:, None]
        if pr_flat is not None:
            # An init cell stage 1 already revealed is not new: it enters
            # the statistics once, as the chain body's ``already`` skip.
            new0 = new0 & ~torch.gather(pr_flat, 1, flat_t0)
        vals0, stats0 = cells_fused(all_docs, flat_t0 + tok_off, new0)
        vals0, stats0 = _guarded_stats(vals0, new0, stats0)
        cellvals0 = torch.where(flat_mask[:, None],
                                torch.full((Q * N, T), _UNREV, device=dev),
                                0.0)
        if pr_flat is not None:
            cellvals0 = torch.where(pr_flat, pv_flat, cellvals0)
            stats0 = stats0 + torch.stack(
                [pr_flat.sum(-1).to(torch.float32), pv_flat.sum(-1),
                 (pv_flat * pv_flat).sum(-1)], dim=-1)
        cellvals0 = _scatter_min(cellvals0, all_docs, flat_t0,
                                 torch.where(new0, vals0, _UNREV))
        if carry is not None:
            cellvals0 = torch.where(fresh_rows[:, None], cellvals0,
                                    carry.cellvals)
            stats0 = torch.where(fresh_rows[:, None], stats0, carry.stats)

        def fused_trip(st: FrontierState, active):
            revealed = st.cellvals < _REV_THRESH                 # (Q*N, T)
            n_q = st.stats[:, 0].reshape(Q, N)
            iv = get_intervals(n_q, st.stats[:, 1].reshape(Q, N),
                               st.stats[:, 2].reshape(Q, N),
                               revealed.reshape(Q, N, T))
            draw, sel, f_doc, f_tok, f_cell, no_progress, occ = select_round(
                st.draw, iv, revealed.reshape(Q, N, T), n_q, active,
                compact=half_w > half)
            # One fused reveal launch + a two-scatter state update. The
            # selection only emits unrevealed cells, so f_cell IS the
            # fresh-cell mask.
            new = f_cell
            vals, dstats = cells_fused(f_doc, f_tok + tok_off[f_doc], new)
            vals, dstats = _guarded_stats(vals, new, dstats)
            return FrontierState(
                cellvals=_scatter_min(st.cellvals, f_doc, f_tok,
                                      torch.where(new, vals, _UNREV)),
                stats=st.stats.index_add(0, f_doc, dstats),
                draw=draw,
                rounds=st.rounds + active.to(torch.int64),
                done=st.done | (active & (sel.stop | no_progress))), occ

        # A trip launches the compacted F-row frontier with growth, else
        # the Q*W selection rows.
        trip_rows = F if half_w > half else Q * W
        state0 = FrontierState(cellvals0, stats0, draw0, rounds0, done0)
        if graph is None:
            state, trips, occ_sum = run_loop(fused_trip, state0, trip_rows)
        else:
            replayed, state0 = graph.bind(fused_trip, state0)
            state, trips, occ_sum = run_loop(replayed, state0, trip_rows)
            state = graph.release(state)
        res = finalize(state.stats[:, 0], state.stats[:, 1],
                       state.stats[:, 2], state.cellvals < _REV_THRESH,
                       state.rounds, trips, occ_sum,
                       (state.cellvals <= _QUAR_THRESH).any(dim=-1))
        return (res, state) if return_state else res

    # Chain round body: abstract cell gather + the _apply_block_reveal
    # update over a stacked BanditState.
    state = BanditState(
        values=torch.zeros((Q * N, T), dtype=torch.float32, device=dev),
        revealed=(~doc_mask).reshape(Q * N, 1).expand(Q * N, T).clone(),
        n=torch.zeros((Q * N,), dtype=torch.int64, device=dev),
        total=torch.zeros((Q * N,), dtype=torch.float32, device=dev),
        total_sq=torch.zeros((Q * N,), dtype=torch.float32, device=dev),
        rounds=rounds0, done=done0, draw=draw0)
    if carry is not None:
        # Unpack the sentinel encoding for carried rows (fresh rows keep the
        # cold start): revealed <=> below the threshold, unrevealed = 0.
        c_rev = carry.cellvals < _REV_THRESH
        fr = fresh_rows[:, None]
        state = state._replace(
            values=torch.where(fr, state.values,
                               torch.where(c_rev, carry.cellvals, 0.0)),
            revealed=torch.where(fr, state.revealed, c_rev),
            n=torch.where(fresh_rows, state.n,
                          carry.stats[:, 0].to(torch.int64)),
            total=torch.where(fresh_rows, state.total, carry.stats[:, 1]),
            total_sq=torch.where(fresh_rows, state.total_sq,
                                 carry.stats[:, 2]))
    if pr_flat is not None:
        # Seed the statistics; the init reveal then skips these cells via
        # _apply_block_reveal's ``already`` check.
        state = state._replace(
            values=state.values + pv_flat,
            revealed=state.revealed | pr_flat,
            n=state.n + pr_flat.sum(-1),
            total=state.total + pv_flat.sum(-1),
            total_sq=state.total_sq + (pv_flat * pv_flat).sum(-1))
    init_valid = doc_mask.reshape(Q * N, 1)
    if carry is not None:
        init_valid = init_valid & fresh_rows[:, None]
    init_vals = _sanitize(compute_cells(all_docs, flat_t0 + tok_off))
    state = _apply_block_reveal(state, all_docs, flat_t0, init_vals,
                                init_valid)

    def chain_trip(st: BanditState, active):
        iv = get_intervals(st.n.reshape(Q, N), st.total.reshape(Q, N),
                           st.total_sq.reshape(Q, N),
                           st.revealed.reshape(Q, N, T))
        draw, sel, f_doc, f_tok, f_cell, no_progress, occ = select_round(
            st.draw, iv, st.revealed.reshape(Q, N, T), st.n.reshape(Q, N),
            active, compact=True)
        vals = _sanitize(compute_cells(f_doc, f_tok + tok_off[f_doc]))
        nxt = _apply_block_reveal(st, f_doc, f_tok, vals, f_cell)
        # A query that separates this round reveals nothing (its slots were
        # masked out of the frontier) and retires with rounds+1.
        return nxt._replace(
            draw=draw, rounds=st.rounds + active.to(torch.int64),
            done=st.done | (active & (sel.stop | no_progress))), occ

    state, trips, occ_sum = run_loop(chain_trip, state, F)
    res = finalize(state.n, state.total, state.total_sq, state.revealed,
                   state.rounds, trips, occ_sum,
                   (state.revealed & (state.values <= _QUAR_THRESH)
                    ).any(dim=-1))
    if not return_state:
        return res
    # Pack back to the sentinel encoding, the slice boundary format of both
    # bodies.
    return res, FrontierState(
        cellvals=torch.where(state.revealed, state.values, _UNREV),
        stats=torch.stack([state.n.to(torch.float32), state.total,
                           state.total_sq], dim=-1),
        draw=state.draw, rounds=state.rounds, done=state.done)


def run_pooled_slice(compute_cells: CellFn, a: torch.Tensor, b: torch.Tensor,
                     seeds: torch.Tensor, cfg: BatchedConfig,
                     carry: FrontierState, fresh: torch.Tensor, *,
                     trip_limit: int, **kw) -> Tuple[PooledResult,
                                                      FrontierState]:
    """One bounded segment of the pooled bandit, the continuous-batching
    step: resume from ``carry``, re-initialise the ``fresh`` slots from
    this call's ``a``/``b``/``seeds`` (and ``prereveal``/``doc_mask`` via
    ``**kw``), run at most ``trip_limit`` trips and return ``(PooledResult,
    FrontierState)``. The host harvests slots whose returned ``done`` is
    set, marks them fresh and calls again. Start a stream from
    :func:`init_frontier_state` with ``fresh`` all-True."""
    return run_pooled_bandit(compute_cells, a, b, seeds, cfg, carry=carry,
                             fresh=fresh, trip_limit=trip_limit,
                             return_state=True, **kw)


def run_pooled_oracle(h_full: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, seeds: torch.Tensor, *,
                      draws: Optional[DrawSource] = None, fused: bool = True,
                      doc_mask=None, **cfg_kw) -> PooledResult:
    """Oracle-mode pooled engine: cells come from a precomputed (Q, N, T)
    H tensor. Flat token ids map back to each slot's own query (doc q*N+i
    only ever pairs with tokens q*T+t). ``cfg_kw`` are the
    :class:`BatchedConfig` fields."""
    Q, N, T = h_full.shape
    h_flat = h_full.reshape(Q * N, T).to(torch.float32)

    def cells(flat_doc, flat_tok):
        t_local = flat_tok - (flat_doc // N * T)[:, None]
        return h_flat[flat_doc[:, None], torch.clamp(t_local, 0, T - 1)]

    return run_pooled_bandit(cells, a, b, seeds, BatchedConfig(**cfg_kw),
                             draws=draws, doc_mask=doc_mask, fused=fused)
