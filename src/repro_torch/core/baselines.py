"""Non-adaptive reveal baselines (paper App. A.3) and exact scoring (port
of ``repro.core.baselines``).

Doc-Uniform   (Algorithm 2): per row, reveal ceil(gamma*T) cells uniformly
              at random without replacement; rank by the partial sums.
Doc-TopMargin (Algorithm 3): per row, reveal the ceil(gamma*T) cells with the
              largest support width (b - a); rank by the partial sums.
Exact         : full scoring, the non-pruned reference (100% coverage).

Sorts are stable (``jnp.argsort``'s order) and top-k is ``stable_topk``
(``lax.top_k``'s), so ties break as in JAX.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.bandit import stable_topk
from repro_torch.core.draws import TORCH_DRAWS, DrawSource

_NEG = -3e38


class BaselineResult(NamedTuple):
    topk: torch.Tensor       # (K,)
    coverage: torch.Tensor   # () f32
    scores: torch.Tensor     # (N,) partial-sum scores
    revealed: torch.Tensor   # (N, T) bool


def _finish(scores: torch.Tensor, revealed: torch.Tensor, k: int,
            doc_mask: torch.Tensor) -> BaselineResult:
    scores = torch.where(doc_mask, scores, _NEG)
    _, topk = stable_topk(scores, k)
    n_rev = (revealed & doc_mask[:, None]).sum()
    n_cells = torch.clamp(doc_mask.sum() * revealed.shape[1], min=1)
    return BaselineResult(
        topk=topk, coverage=n_rev.to(torch.float32) / n_cells.to(
            torch.float32),
        scores=scores, revealed=revealed & doc_mask[:, None])


def _first_by_rank(key: torch.Tensor, budget: int) -> torch.Tensor:
    """Cells whose stable ascending rank of ``key`` within the row is below
    ``budget``."""
    order = torch.argsort(key, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True) < budget


def _mask_or_all(doc_mask, h_full):
    if doc_mask is None:
        return torch.ones(h_full.shape[:1], dtype=torch.bool,
                          device=h_full.device)
    return doc_mask


def doc_uniform(h_full: torch.Tensor, seed: torch.Tensor, *, k: int,
                budget: int, doc_mask: Optional[torch.Tensor] = None,
                draws: Optional[DrawSource] = None) -> BaselineResult:
    """Algorithm 2 with per-row budget B = ``budget`` cells; the random
    order is ``draws.uniform(seed, (N, T))`` ranked per row."""
    draws = draws or TORCH_DRAWS
    N, T = h_full.shape
    doc_mask = _mask_or_all(doc_mask, h_full)
    budget = max(1, min(budget, T))
    noise = draws.uniform(seed.to(h_full.device), (N, T))
    revealed = _first_by_rank(noise, budget)
    scores = torch.where(revealed, h_full, 0.0).sum(dim=-1)
    return _finish(scores, revealed, k, doc_mask)


def doc_top_margin(h_full: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                   k: int, budget: int,
                   doc_mask: Optional[torch.Tensor] = None) -> BaselineResult:
    """Algorithm 3: reveal the top-B cells per row by support width b-a."""
    T = h_full.shape[1]
    doc_mask = _mask_or_all(doc_mask, h_full)
    budget = max(1, min(budget, T))
    revealed = _first_by_rank(-(b - a).to(torch.float32), budget)
    scores = torch.where(revealed, h_full, 0.0).sum(dim=-1)
    return _finish(scores, revealed, k, doc_mask)


def exact_topk(h_full: torch.Tensor, *, k: int,
               doc_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full ColBERT scoring (Eq. 2/3): S_i = sum_t H_it, then top-K."""
    doc_mask = _mask_or_all(doc_mask, h_full)
    scores = torch.where(doc_mask, h_full.sum(dim=-1), _NEG)
    _, topk = stable_topk(scores, k)
    return topk, scores
