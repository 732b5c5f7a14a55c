"""Pooled cross-query reveal engine (port of ``repro.core.frontier``,
one-shot path).

One global loop drives all Q queries of a batch at once:

  1. every trip, each still-active query runs the shared LUCB block
     selection (``core.batched._round_select``),
  2. the selected (doc, token) blocks of all queries are pooled into one
     frontier: doc ids are query-offset into the stacked (Q*N, L, M)
     candidate tensor, token ids into the stacked (Q*T, M) token table,
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

The JAX package's ``jax.random`` key chain is replaced by a
:class:`DrawSource`; its streaming (``carry``/``fresh``/``trip_limit``/
``return_state``), fidelity-knob (``alpha_scale``/``round_cap``) and
``prereveal`` parameters are not ported yet. The loop's continue test
reads one flag from the device per trip (one host sync per trip).
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Protocol, Tuple

import torch

from repro_torch.core import bounds as B
from repro_torch.core.bandit import _select_arms, _topk_mask
from repro_torch.core.batched import (BatchedConfig, _apply_block_reveal,
                                      _round_select)
from repro_torch.core.state import BanditState
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


class DrawSource(Protocol):
    """The random draws of one pooled run — the port's counterpart of the
    JAX package's per-query PRNG keys.

    ``init_tokens`` gives the init reveal's token per candidate
    (``jax.random.randint`` in JAX); ``round(trip)`` gives, for every
    query, the exploration uniforms (Q, W, 1) and Gumbel noise (Q, W, T) of
    that global trip (``_round_select``'s ``uniform`` / ``gumbel``). Every
    query consumes one ``round`` per trip, retired or not."""

    def init_tokens(self, Q: int, N: int, T: int) -> torch.Tensor: ...

    def round(self, trip: int, Q: int, W: int,
              T: int) -> Tuple[torch.Tensor, torch.Tensor]: ...


class TorchDraws:
    """Draws from one ``torch.Generator`` seeded with ``seed``, on the run's
    device. Reproducible for a seed and device; not JAX's bits."""

    def __init__(self, seed: int, device="cuda"):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def init_tokens(self, Q: int, N: int, T: int) -> torch.Tensor:
        return torch.randint(0, T, (Q, N), generator=self.gen,
                             device=self.device)

    def round(self, trip: int, Q: int, W: int,
              T: int) -> Tuple[torch.Tensor, torch.Tensor]:
        u = torch.rand((Q, W, 1), generator=self.gen, device=self.device)
        v = torch.rand((Q, W, T), generator=self.gen, device=self.device)
        tiny = torch.finfo(torch.float32).tiny
        return u, -torch.log(-torch.log(torch.clamp(v, min=tiny)))


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


CellFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


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


def run_pooled_bandit(
    compute_cells: CellFn,
    a: torch.Tensor,                # (Q, N, T) lower support per cell
    b: torch.Tensor,                # (Q, N, T) upper support per cell
    draws: DrawSource,
    cfg: BatchedConfig,
    *,
    doc_mask: Optional[torch.Tensor] = None,   # (Q, N) bool valid candidates
    compute_cells_fused: Optional[Callable] = None,  # derived when omitted
    fused: bool = True,
) -> PooledResult:
    """Run the pooled bandit to quiescence and return per-query results.

    ``compute_cells(flat_doc (S,), flat_tok (S, G)) -> (S, G)`` reveals
    cells of the stacked axes (doc q*N+i pairs only with tokens q*T+t of
    the same query); ``compute_cells_fused(flat_doc, flat_tok, new_mask)
    -> (vals (S, G), stats (S, 3))`` is the fused contract.

    Finite-score guard (always on): a revealed cell that comes back
    non-finite is recorded as ``_QUAR``; its doc is excluded from the
    final top-K and counted in ``PooledResult.quarantined``.
    """
    Q, N, T = a.shape
    dev = a.device
    k = cfg.k
    G = cfg.block_tokens
    half = max(cfg.block_docs // 2, 1)
    # Selection widths per query: fixed (== solo) unless growth is enabled,
    # clamped to N / T.
    half_w = min(max(cfg.max_block_docs // 2, half), max(N, 1))
    W = 2 * half_w                           # per-query selection rows
    G_cap = min(max(cfg.max_block_tokens, G), max(T, 1))  # token sel width
    F = Q * 2 * half                         # frontier capacity (slots)
    max_rounds = cfg.max_rounds
    if max_rounds <= 0:
        max_rounds = (N * T) // max(cfg.block_docs * G, 1) + T + 8
    if doc_mask is None:
        doc_mask = torch.ones((Q, N), dtype=torch.bool, device=dev)
    a = torch.where(doc_mask[:, :, None], a, 0.0).to(torch.float32)
    b = torch.where(doc_mask[:, :, None], b, 0.0).to(torch.float32)

    q_doc_off = (torch.arange(Q, device=dev) * N)[:, None]       # (Q, 1)
    tok_off = (torch.arange(Q * N, device=dev) // N * T)[:, None]

    # Init reveal (paper footnote 2): one random cell per doc, all queries
    # pooled into a single (Q*N, 1) reveal.
    t0 = draws.init_tokens(Q, N, T).to(device=dev, dtype=torch.int64)
    all_docs = torch.arange(Q * N, device=dev)
    flat_t0 = t0.reshape(Q * N, 1)

    iv_kwargs = dict(T=T, N=N, delta=cfg.delta, alpha_ef=cfg.alpha_ef,
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

    def select_round(trip, iv, revealed_q, n_q, active, *, compact):
        """Shared round front-end: per-query LUCB selection, capacity
        allotment over both growth axes, and frontier pooling."""
        explore_u, gumbel = draws.round(trip, Q, W, T)
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
        return sel, f_doc, f_tok, f_cell, no_progress, occ

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
            lockstep_waste=torch.clamp(Q * trips_t - total_rounds, min=0),
            occupancy=occ_sum / max(float(trips), 1.0),
            quarantined=quar_q.sum(dim=1),
        )

    def running(done, rounds) -> Tuple[torch.Tensor, bool]:
        active = ~done & (rounds < max_rounds)
        return active, bool(active.any())     # the one host sync per trip

    # Queries with NO valid candidate start retired (rounds stay 0).
    done = ~doc_mask.any(dim=1)
    rounds = torch.zeros((Q,), dtype=torch.int64, device=dev)
    occ_sum = torch.zeros((), dtype=torch.float32, device=dev)
    trips = 0

    if fused:
        cells_fused = (compute_cells_fused if compute_cells_fused is not None
                       else _with_stats(compute_cells))
        flat_mask = doc_mask.reshape(Q * N)
        new0 = flat_mask[:, None]                               # (Q*N, 1)
        vals0, stats = cells_fused(all_docs, flat_t0 + tok_off, new0)
        vals0, stats = _guarded_stats(vals0, new0, stats)
        cellvals = torch.where(flat_mask[:, None],
                               torch.full((Q * N, T), _UNREV, device=dev),
                               0.0)
        cellvals = _scatter_min(cellvals, all_docs, flat_t0,
                                torch.where(new0, vals0, _UNREV))
        active, go = running(done, rounds)
        while go:
            revealed = cellvals < _REV_THRESH                    # (Q*N, T)
            n_q = stats[:, 0].reshape(Q, N)
            iv = get_intervals(n_q, stats[:, 1].reshape(Q, N),
                               stats[:, 2].reshape(Q, N),
                               revealed.reshape(Q, N, T))
            sel, f_doc, f_tok, f_cell, no_progress, occ = select_round(
                trips, iv, revealed.reshape(Q, N, T), n_q, active,
                compact=half_w > half)
            # One fused reveal launch + a two-scatter state update. The
            # selection only emits unrevealed cells, so f_cell IS the
            # fresh-cell mask.
            new = f_cell
            vals, dstats = cells_fused(f_doc, f_tok + tok_off[f_doc], new)
            vals, dstats = _guarded_stats(vals, new, dstats)
            cellvals = _scatter_min(cellvals, f_doc, f_tok,
                                    torch.where(new, vals, _UNREV))
            stats = stats.index_add(0, f_doc, dstats)
            rounds = rounds + active.to(torch.int64)
            done = done | (active & (sel.stop | no_progress))
            trips += 1
            occ_sum = occ_sum + occ
            active, go = running(done, rounds)
        return finalize(stats[:, 0], stats[:, 1], stats[:, 2],
                        cellvals < _REV_THRESH, rounds, trips, occ_sum,
                        (cellvals <= _QUAR_THRESH).any(dim=-1))

    # Chain round body: abstract cell gather + the _apply_block_reveal
    # update over a stacked BanditState.
    state = BanditState(
        values=torch.zeros((Q * N, T), dtype=torch.float32, device=dev),
        revealed=(~doc_mask).reshape(Q * N, 1).expand(Q * N, T).clone(),
        n=torch.zeros((Q * N,), dtype=torch.int64, device=dev),
        total=torch.zeros((Q * N,), dtype=torch.float32, device=dev),
        total_sq=torch.zeros((Q * N,), dtype=torch.float32, device=dev),
        rounds=rounds, done=done)
    init_vals = _sanitize(compute_cells(all_docs, flat_t0 + tok_off))
    state = _apply_block_reveal(state, all_docs, flat_t0, init_vals,
                                doc_mask.reshape(Q * N, 1))
    active, go = running(state.done, state.rounds)
    while go:
        iv = get_intervals(state.n.reshape(Q, N), state.total.reshape(Q, N),
                           state.total_sq.reshape(Q, N),
                           state.revealed.reshape(Q, N, T))
        sel, f_doc, f_tok, f_cell, no_progress, occ = select_round(
            trips, iv, state.revealed.reshape(Q, N, T),
            state.n.reshape(Q, N), active, compact=True)
        vals = _sanitize(compute_cells(f_doc, f_tok + tok_off[f_doc]))
        state = _apply_block_reveal(state, f_doc, f_tok, vals, f_cell)
        # A query that separates this round reveals nothing (its slots were
        # masked out of the frontier) and retires with rounds+1.
        state = state._replace(
            rounds=state.rounds + active.to(torch.int64),
            done=state.done | (active & (sel.stop | no_progress)))
        trips += 1
        occ_sum = occ_sum + occ
        active, go = running(state.done, state.rounds)
    return finalize(state.n, state.total, state.total_sq, state.revealed,
                    state.rounds, trips, occ_sum,
                    (state.revealed & (state.values <= _QUAR_THRESH)
                     ).any(dim=-1))


def _rows_to(table: torch.Tensor, dump: torch.Tensor,
             rows: torch.Tensor) -> torch.Tensor:
    """Scatter ``rows`` into ``table`` at row indices ``dump``."""
    return table.scatter(0, dump[:, None].expand_as(rows), rows)


def run_pooled_oracle(h_full: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, draws: DrawSource, *,
                      fused: bool = True, doc_mask=None,
                      **cfg_kw) -> PooledResult:
    """Oracle-mode pooled engine: cells come from a precomputed (Q, N, T)
    H tensor. Flat token ids map back to each slot's own query (doc q*N+i
    only ever pairs with tokens q*T+t). ``cfg_kw`` are the
    :class:`BatchedConfig` fields."""
    Q, N, T = h_full.shape
    h_flat = h_full.reshape(Q * N, T).to(torch.float32)

    def cells(flat_doc, flat_tok):
        t_local = flat_tok - (flat_doc // N * T)[:, None]
        return h_flat[flat_doc[:, None], torch.clamp(t_local, 0, T - 1)]

    return run_pooled_bandit(cells, a, b, draws, BatchedConfig(**cfg_kw),
                             doc_mask=doc_mask, fused=fused)
