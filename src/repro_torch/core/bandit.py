"""Col-Bandit, faithful sequential LUCB (paper Algorithm 1), and the LUCB
arm selection shared by every engine (port of ``repro.core.bandit``).

:func:`run_bandit` reveals ONE (document, token) MaxSim cell per
iteration, exactly as the paper writes it: the correctness oracle and the
paper-faithful baseline of the research harness
(``retrieval.pipeline.rerank_query``). Its environment is a precomputed
MaxSim matrix ``h_full`` (N, T).

``jax.lax.top_k`` orders equal values by the lower index, and the bandit
relies on it: under the ``_NEG`` masks and a generic (0, 1) support most
candidates tie. ``torch.topk`` promises no tie order, so every top-k here
goes through :func:`stable_topk`."""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import bounds as B
from repro_torch.core.bounds import Intervals
from repro_torch.core.draws import TORCH_DRAWS, DrawSource
from repro_torch.core.state import (BanditState, init_state, reveal_cell,
                                    reveal_mask)

_NEG = -3e38
_POS = 3e38
_I31 = 2 ** 31


class BanditResult(NamedTuple):
    topk: torch.Tensor        # (K,) i64 — returned document indices
    coverage: torch.Tensor    # () f32 — Eq. 6 over valid docs
    reveals: torch.Tensor     # () i64 — |Omega|
    rounds: torch.Tensor      # () i64 — LUCB iterations
    separated: torch.Tensor   # () bool — stopped via LCB >= UCB (vs budget)
    s_hat: torch.Tensor       # (N,) f32 — final score estimates
    revealed: torch.Tensor    # (N, T) bool — final observation set


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ``jax.lax.top_k``'s order: values
    descending, equal values by ascending index.

    Each float32 value and its index are packed into one unique int64 key
    (order-preserving float bits in the high part, the complemented index
    in the low 31 bits), so a plain ``torch.topk`` on the keys is exact and
    deterministic in O(n) on any device. ``-0.0`` is folded into ``+0.0``
    first, since the two compare equal. NaN is not supported.
    """
    n = x.shape[-1]
    if not 0 <= k <= n or n >= _I31:
        raise ValueError(f"stable_topk: need 0 <= k <= n < 2**31, got "
                         f"k={k}, n={n}")
    xf = x.to(torch.float32) + 0.0
    bits = xf.view(torch.int32).to(torch.int64)
    ordered = torch.where(bits >= 0, bits + _I31, _I31 - 1 - (bits & (_I31 - 1)))
    idx = torch.arange(n, device=x.device, dtype=torch.int64)
    _, pos = torch.topk(ordered * _I31 + (_I31 - 1 - idx), k, dim=-1)
    return torch.gather(x, -1, pos), pos


def _topk_mask(scores: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Boolean membership mask of the current Top-K by score (stable ties)."""
    _, idx = stable_topk(scores, k)
    mask = torch.zeros_like(scores, dtype=torch.bool).scatter_(-1, idx, True)
    return mask, idx


def _select_arms(iv: Intervals, topk_mask: torch.Tensor,
                 valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weakest winner i+ and strongest loser i- (Sec. 4.3). ``argmin`` and
    ``argmax`` return the first index on ties, as in JAX."""
    i_plus = torch.argmin(torch.where(topk_mask & valid, iv.lcb, _POS), dim=-1)
    i_minus = torch.argmax(torch.where(~topk_mask & valid, iv.ucb, _NEG),
                           dim=-1)
    return i_plus, i_minus


def run_bandit(h_full: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               seed: torch.Tensor, *, k: int, delta: float = 0.01,
               alpha_ef: float = 0.3, epsilon: float = 0.1,
               radius_c: float = 1.0, bias_kappa: float = 0.0,
               warmup_fraction: float = 0.0, max_reveals: int = -1,
               init_one_per_doc: bool = True,
               doc_mask: Optional[torch.Tensor] = None,
               prereveal: Optional[torch.Tensor] = None,
               draws: Optional[DrawSource] = None) -> BanditResult:
    """Algorithm 1 over the oracle matrix ``h_full`` (N, T) with supports
    a/b (N, T); returns the estimated Top-K set and the cost paid.

    ``seed`` is the query's seed for ``draws`` (default ``TorchDraws``):
    ``init_alg1`` gives the init cell per doc and the warm-up cells, and
    every iteration takes one ``round`` (W = 1: the exploration coin and a
    (T,) Gumbel draw). ``prereveal`` (N, T) cells are revealed for free
    before the loop. One host read per iteration (the loop's test); the
    iteration itself reads nothing back."""
    draws = draws or TORCH_DRAWS
    N, T = h_full.shape
    dev = h_full.device
    if doc_mask is None:
        doc_mask = torch.ones((N,), dtype=torch.bool, device=dev)
    budget = max_reveals if max_reveals > 0 else N * T
    # Invalid (padding) docs: zero support, fully revealed, never selected.
    a = torch.where(doc_mask[:, None], a, 0.0).to(torch.float32)
    b = torch.where(doc_mask[:, None], b, 0.0).to(torch.float32)
    h_full = torch.where(doc_mask[:, None], h_full, 0.0)

    n_warm = (math.ceil(warmup_fraction * N * T) if warmup_fraction > 0.0
              else 0)
    draw, t0, warm_idx = draws.init_alg1(seed.to(dev), N, T, n_warm)
    state = init_state(N, T, draw)
    state = state._replace(revealed=state.revealed | ~doc_mask[:, None])

    # -- Exploration init (Sec. 4.1) -----------------------------------------
    if prereveal is not None:
        state = reveal_mask(state, h_full, prereveal & doc_mask[:, None])
    if init_one_per_doc:
        # footnote 2: one uniformly random cell per document.
        mask0 = ((torch.arange(T, device=dev)[None, :]
                  == t0.to(dev)[:, None]) & doc_mask[:, None])
        state = reveal_mask(state, h_full, mask0)
    if n_warm:
        # static warm-up: gamma_init * N * T cells without replacement.
        warm = torch.zeros((N * T,), dtype=torch.bool, device=dev)
        warm = warm.index_fill(0, warm_idx.to(dev), True).reshape(N, T)
        state = reveal_mask(state, h_full, warm & doc_mask[:, None])

    iv_kwargs = dict(T=T, N=N, delta=delta, alpha_ef=alpha_ef, c=radius_c,
                     bias_kappa=bias_kappa)

    def get_intervals(st: BanditState) -> Intervals:
        iv = B.intervals(st.n, st.total, st.total_sq, st.revealed, a, b,
                         **iv_kwargs)
        return iv._replace(s_hat=torch.where(doc_mask, iv.s_hat, _NEG),
                           lcb=torch.where(doc_mask, iv.lcb, _NEG),
                           ucb=torch.where(doc_mask, iv.ucb, _NEG))

    def body(st: BanditState) -> BanditState:
        iv = get_intervals(st)
        tk_mask, _ = _topk_mask(iv.s_hat, k)                    # line 4
        i_plus, i_minus = _select_arms(iv, tk_mask, doc_mask)   # lines 5-6
        stop = iv.lcb[i_plus] >= iv.ucb[i_minus]                # line 7

        # line 10: the more ambiguous of the two (a fully-observed row has
        # width 0, so fall back to the one with unrevealed cells).
        full_p = st.n[i_plus] >= T
        full_m = st.n[i_minus] >= T
        w_plus = torch.where(full_p, _NEG, iv.ucb[i_plus] - iv.lcb[i_plus])
        w_minus = torch.where(full_m, _NEG,
                              iv.ucb[i_minus] - iv.lcb[i_minus])
        i_star = torch.where(w_plus >= w_minus, i_plus, i_minus)

        # lines 11-16: epsilon-greedy token choice within the row.
        draw, u, g = draws.round(st.draw, 1, T)
        unrev = ~st.revealed[i_star]
        width = torch.where(unrev, b[i_star] - a[i_star], _NEG)
        t_exploit = torch.argmax(width)                         # Max-Width
        t_explore = torch.argmax(torch.where(unrev, g[0, 0], _NEG))
        t_star = torch.where(u[0, 0, 0] < epsilon, t_explore, t_exploit)

        nxt = reveal_cell(st, h_full, i_star, t_star)           # lines 17-20
        return BanditState(*(torch.where(stop, old, new) for old, new
                             in zip(st[:5], nxt[:5])),
                           rounds=st.rounds + 1,
                           done=stop | (full_p & full_m), draw=draw)

    def n_revealed(st: BanditState) -> torch.Tensor:
        return (st.revealed & doc_mask[:, None]).sum()

    while bool(~state.done & (n_revealed(state) < budget)):
        state = body(state)

    iv = get_intervals(state)
    tk_mask, topk_idx = _topk_mask(iv.s_hat, k)
    i_plus, i_minus = _select_arms(iv, tk_mask, doc_mask)
    n_rev = n_revealed(state)
    n_cells = torch.clamp(doc_mask.sum() * T, min=1)
    return BanditResult(
        topk=topk_idx,
        coverage=n_rev.to(torch.float32) / n_cells.to(torch.float32),
        reveals=n_rev,
        rounds=state.rounds,
        separated=iv.lcb[i_plus] >= iv.ucb[i_minus],
        s_hat=iv.s_hat,
        revealed=state.revealed & doc_mask[:, None])
