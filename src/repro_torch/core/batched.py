"""Block-synchronous Col-Bandit (port of ``repro.core.batched``).

Every round selects the ``half`` weakest winners and ``half`` strongest
losers per query and reveals G epsilon-greedy max-width tokens for each.
The JAX version draws its exploration coin and Gumbel noise from a key
inside :func:`_round_select`; here the draws come in as tensors (from a
``core.draws.DrawSource``), so the same policy can replay JAX's draws bit
for bit in the parity tests.

:func:`run_batched_bandit` is the solo loop (one query; the lockstep
engine of ``retrieval.service`` and ``rerank_query(method="batched")``
run it), :func:`_round_select` and :func:`_apply_block_reveal` are shared
with the pooled engine (``core.frontier``). The reveal is abstracted as
``compute_cells(doc_idx (B,), tok_idx (B, G)) -> values (B, G)``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import bounds as B
from repro_torch.core.bandit import (BanditResult, _select_arms, _topk_mask,
                                     stable_topk)
from repro_torch.core.bounds import Intervals
from repro_torch.core.draws import TORCH_DRAWS, DrawSource
from repro_torch.core.state import BanditState, init_state
from repro_torch.kernels.reveal import reveal_stats

CellFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_NEG = -3e38


class BatchedConfig(NamedTuple):
    k: int
    delta: float = 0.01
    alpha_ef: float = 0.3
    epsilon: float = 0.1
    radius_c: float = 1.0
    bias_kappa: float = 0.0
    block_docs: int = 8       # B
    block_tokens: int = 8     # G
    max_rounds: int = -1      # -1 => (N*T) // (B*G) + T + 8
    # Pooled engine: when > block_docs, retired queries' reveal slots let
    # still-active queries grow their per-round doc block up to this many
    # docs. 0 keeps blocks fixed at ``block_docs``.
    max_block_docs: int = 0
    # Second growth axis: freed cell capacity widens each surviving slot's
    # token block up to this many tokens. 0 keeps ``block_tokens``.
    max_block_tokens: int = 0


class RoundSelection(NamedTuple):
    """One round's block selection, batched over leading query axes."""

    doc_idx: torch.Tensor    # (..., 2*half) i64 selected docs (winners ++ losers)
    tok_idx: torch.Tensor    # (..., 2*half, G) i64 selected tokens per doc
    cell_ok: torch.Tensor    # (..., 2*half, G) bool — cell is fresh and selectable
    stop: torch.Tensor       # (...,) bool — LUCB separation reached this round


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., N, T) rows picked by idx (..., W) -> (..., W, T)."""
    return torch.gather(
        x, -2, idx.unsqueeze(-1).expand(*idx.shape, x.shape[-1]))


def _round_select(explore_u: torch.Tensor, gumbel: torch.Tensor,
                  iv: Intervals, revealed: torch.Tensor, n: torch.Tensor,
                  a: torch.Tensor, b: torch.Tensor, doc_mask: torch.Tensor,
                  *, k: int, epsilon: float, half: int,
                  G: int) -> RoundSelection:
    """LUCB block selection (Sec. 4.3, batched): ``half`` weakest winners +
    ``half`` strongest losers, G epsilon-greedy max-width tokens per doc.

    explore_u (..., 2*half, 1) uniform and gumbel (..., 2*half, T) are the
    round's draws (``jax.random.uniform`` / ``gumbel`` in the JAX
    package). A pure function of draws and statistics, so the fused and
    chain round bodies make identical choices from identical state."""
    T = a.shape[-1]
    tk_mask, _ = _topk_mask(iv.s_hat, k)
    i_plus, i_minus = _select_arms(iv, tk_mask, doc_mask)
    stop = (torch.gather(iv.lcb, -1, i_plus.unsqueeze(-1))
            >= torch.gather(iv.ucb, -1, i_minus.unsqueeze(-1))).squeeze(-1)

    has_unrev = n < T
    # half weakest winners: smallest LCB within the current top-K.
    win_score = torch.where(tk_mask & doc_mask & has_unrev, -iv.lcb, _NEG)
    win_val, win_idx = stable_topk(win_score, half)
    # half strongest losers: largest UCB outside the top-K.
    lose_score = torch.where(~tk_mask & doc_mask & has_unrev, iv.ucb, _NEG)
    lose_val, lose_idx = stable_topk(lose_score, half)

    doc_idx = torch.cat([win_idx, lose_idx], dim=-1)
    doc_ok = torch.cat([win_val, lose_val], dim=-1) > _NEG / 2

    # Token choice per selected doc: epsilon-greedy max-width, top-G.
    unrev = ~_take_rows(revealed, doc_idx)
    width = torch.where(unrev, _take_rows(b, doc_idx) - _take_rows(a, doc_idx),
                        _NEG)
    noise = torch.where(unrev, gumbel, _NEG)
    explore = explore_u < epsilon
    sel_score = torch.where(explore, noise, width)
    top_w, tok_idx = stable_topk(sel_score, G)
    cell_ok = (top_w > _NEG / 2) & doc_ok.unsqueeze(-1)
    return RoundSelection(doc_idx=doc_idx, tok_idx=tok_idx, cell_ok=cell_ok,
                          stop=stop)


def _apply_block_reveal(state: BanditState, doc_idx: torch.Tensor,
                        tok_idx: torch.Tensor, vals: torch.Tensor,
                        valid: torch.Tensor) -> BanditState:
    """Reveal cells {(doc_idx[s], tok_idx[s, g])} of the stacked (R, T)
    statistics: scatter the values and update (n, total, total_sq). Skips
    already-revealed and invalid entries. Returns a new state.

    The per-row deltas are summed by ``kernels.reveal.reveal_stats``, in
    the fused reveal kernel's own order, so the chain body stays bit-for-bit
    equal to the fused body."""
    R, T = state.values.shape
    rows = doc_idx.unsqueeze(-1).expand_as(tok_idx)
    already = state.revealed[rows, tok_idx]
    new = valid & ~already
    vals = vals.to(torch.float32)
    # Unrevealed slots hold 0.0 and `new` excludes re-reveals, so the
    # scatter-add writes each value exactly once.
    values = state.values.index_put((rows, tok_idx),
                                    torch.where(new, vals, 0.0),
                                    accumulate=True)
    # Scatter-OR (max), not set: an empty frontier slot points at
    # (doc 0, tok 0) with valid=False, so that cell can receive both a live
    # True and the slot's pass-through.
    lin = (rows * T + tok_idx).reshape(-1)
    revealed = state.revealed.reshape(-1).to(torch.uint8).scatter_reduce(
        0, lin, (new | already).reshape(-1).to(torch.uint8), "amax")
    d = reveal_stats(vals, new)
    return state._replace(
        values=values,
        revealed=revealed.to(torch.bool).reshape(R, T),
        n=state.n.index_add(0, doc_idx, new.sum(dim=-1).to(state.n.dtype)),
        total=state.total.index_add(0, doc_idx, d[:, 1]),
        total_sq=state.total_sq.index_add(0, doc_idx, d[:, 2]))


def _max_rounds(cfg: BatchedConfig, N: int, T: int) -> int:
    """``cfg.max_rounds``, or (N*T) // (B*G) + T + 8 when it is <= 0."""
    if cfg.max_rounds > 0:
        return cfg.max_rounds
    return (N * T) // max(cfg.block_docs * cfg.block_tokens, 1) + T + 8


def run_batched_bandit(compute_cells: CellFn, a: torch.Tensor,
                       b: torch.Tensor, seed: torch.Tensor,
                       cfg: BatchedConfig, *,
                       doc_mask: Optional[torch.Tensor] = None,
                       draws: Optional[DrawSource] = None) -> BanditResult:
    """The solo block bandit over one query's (N, T) supports, run to
    quiescence. ``seed`` is the query's seed for ``draws`` (default
    :class:`~repro_torch.core.draws.TorchDraws`). One host read per round
    (the loop's continue test)."""
    draws = draws or TORCH_DRAWS
    N, T = a.shape
    dev = a.device
    k, G = cfg.k, cfg.block_tokens
    half = max(cfg.block_docs // 2, 1)
    max_rounds = _max_rounds(cfg, N, T)
    if doc_mask is None:
        doc_mask = torch.ones((N,), dtype=torch.bool, device=dev)
    a = torch.where(doc_mask[:, None], a, 0.0).to(torch.float32)
    b = torch.where(doc_mask[:, None], b, 0.0).to(torch.float32)

    draw, t0 = draws.init(seed.to(dev)[None], None, None, N, T)
    state = init_state(N, T, draw)
    state = state._replace(revealed=state.revealed | ~doc_mask[:, None])
    all_docs = torch.arange(N, device=dev)
    t0 = t0[0].to(device=dev, dtype=torch.int64)[:, None]
    state = _apply_block_reveal(state, all_docs, t0,
                                compute_cells(all_docs, t0),
                                doc_mask[:, None])

    iv_kwargs = dict(T=T, N=N, delta=cfg.delta, alpha_ef=cfg.alpha_ef,
                     c=cfg.radius_c, bias_kappa=cfg.bias_kappa)

    def get_intervals(st: BanditState) -> Intervals:
        iv = B.intervals(st.n, st.total, st.total_sq, st.revealed, a, b,
                         **iv_kwargs)
        return iv._replace(s_hat=torch.where(doc_mask, iv.s_hat, _NEG),
                           lcb=torch.where(doc_mask, iv.lcb, _NEG),
                           ucb=torch.where(doc_mask, iv.ucb, _NEG))

    def body(st: BanditState) -> BanditState:
        iv = get_intervals(st)
        draw, u, g = draws.round(st.draw, 2 * half, T)
        sel = _round_select(u[0], g[0], iv, st.revealed, st.n, a, b,
                            doc_mask, k=k, epsilon=cfg.epsilon, half=half,
                            G=G)
        vals = compute_cells(sel.doc_idx, sel.tok_idx)
        nxt = _apply_block_reveal(st, sel.doc_idx, sel.tok_idx, vals,
                                  sel.cell_ok)
        # On stop, keep the pre-reveal observation set (don't pay for it).
        return BanditState(*(torch.where(sel.stop, old, new) for old, new
                             in zip(st[:5], nxt[:5])),
                           rounds=st.rounds + 1,
                           done=sel.stop | ~sel.cell_ok.any(), draw=draw)

    while bool(~state.done & (state.rounds < max_rounds)):
        state = body(state)

    iv = get_intervals(state)
    tk_mask, topk_idx = _topk_mask(iv.s_hat, k)
    i_plus, i_minus = _select_arms(iv, tk_mask, doc_mask)
    n_rev = (state.revealed & doc_mask[:, None]).sum()
    n_cells = torch.clamp(doc_mask.sum() * T, min=1)
    return BanditResult(
        topk=topk_idx,
        coverage=n_rev.to(torch.float32) / n_cells.to(torch.float32),
        reveals=n_rev,
        rounds=state.rounds,
        separated=iv.lcb[i_plus] >= iv.ucb[i_minus],
        s_hat=iv.s_hat,
        revealed=state.revealed & doc_mask[:, None])


def run_batched_oracle(h_full: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, seed: torch.Tensor, *,
                       draws: Optional[DrawSource] = None,
                       doc_mask: Optional[torch.Tensor] = None,
                       **cfg_kw) -> BanditResult:
    """Oracle-mode block bandit: cells come from a precomputed (N, T) H
    matrix. ``cfg_kw`` are the :class:`BatchedConfig` fields."""
    h = h_full.to(torch.float32)

    def cells(doc_idx, tok_idx):
        return h[doc_idx[:, None], tok_idx]

    return run_batched_bandit(cells, a, b, seed, BatchedConfig(**cfg_kw),
                              doc_mask=doc_mask, draws=draws)
