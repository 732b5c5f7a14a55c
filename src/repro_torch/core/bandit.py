"""LUCB arm selection shared by the block-synchronous and pooled engines
(port of the selection helpers of ``repro.core.bandit``).

``jax.lax.top_k`` orders equal values by the lower index, and the bandit
relies on it: under the ``_NEG`` masks and a generic (0, 1) support most
candidates tie. ``torch.topk`` promises no tie order, so every top-k here
goes through :func:`stable_topk`."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.bounds import Intervals

_NEG = -3e38
_POS = 3e38
_I31 = 2 ** 31


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
