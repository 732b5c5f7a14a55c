"""Beyond-paper extension: finite-population Top-K identification over ANY
sum-decomposable score.

The counterpart of ``src/repro/core/generalized.py``. The paper's machinery
only needs (i) per-candidate scores of the form S_i = sum_t C_{i,t} with a
finite component set, and (ii) known support [a, b] per component. MaxSim
matrices are one instance; the same bounds/LUCB loop serves:

  * FM retrieval      -- C_{i,f} = contribution of context field f to the FM
                         score of candidate i (``fm_pair_components``, or
                         ``models.recsys.fm_candidate_components``),
  * SASRec/DIN        -- C_{i,g} = per-dimension-group partial dot product of
                         user state with candidate item embedding
                         (``dot_components``).

This turns "score 10^6 candidates" into "reveal only the component blocks
needed to separate the top-K", the direct analogue of the paper's regime.
``topk_bandit_generalized`` takes a seed and a ``DrawSource`` where JAX
takes a key, as ``run_bandit`` and ``run_batched_oracle`` do, and runs
where ``components`` lives.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.core.bandit import BanditResult, run_bandit
from repro_torch.core.batched import run_batched_oracle
from repro_torch.core.draws import TORCH_DRAWS, DrawSource


def component_support(components: torch.Tensor, slack: float = 0.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column support [a_t, b_t] for a component matrix (N, T): the
    tightest bounds available without revealing which row is which.
    ``slack`` widens the interval."""
    a = components.amin(dim=0) - slack                       # (T,)
    b = components.amax(dim=0) + slack
    N = components.shape[0]
    return a.expand(N, a.shape[0]), b.expand(N, b.shape[0])


def dot_components(user: torch.Tensor, items: torch.Tensor,
                   n_groups: int) -> torch.Tensor:
    """Decompose score_i = <user, item_i> into ``n_groups`` contiguous
    dimension-group partial dots -> component matrix (N, n_groups)."""
    d = user.shape[-1]
    if d % n_groups:
        raise ValueError(f"dot_components: dim {d} is not a multiple of "
                         f"n_groups {n_groups}")
    g = d // n_groups
    u = user.reshape(n_groups, g)
    it = items.reshape(items.shape[0], n_groups, g)
    return torch.einsum("ngd,gd->ng", it, u)


def fm_pair_components(query_emb: torch.Tensor,
                       cand_embs: torch.Tensor) -> torch.Tensor:
    """FM cross-term decomposition for retrieval: candidate item i
    interacting with F fixed user/context fields. Component f = <v_item_i,
    v_field_f>. query_emb: (F, D) context field embeddings; cand_embs:
    (N, D)."""
    return torch.einsum("nd,fd->nf", cand_embs, query_emb)


def topk_bandit_generalized(
    components: torch.Tensor,    # (N, T) candidate x component contributions
    seed: Union[int, torch.Tensor],
    *,
    k: int,
    alpha_ef: float = 0.3,
    delta: float = 0.01,
    epsilon: float = 0.1,
    support_slack: float = 0.0,
    batched: bool = True,
    block_docs: int = 32,
    block_tokens: int = 4,
    draws: Optional[DrawSource] = None,
) -> BanditResult:
    """Run Top-K identification over a generic component matrix. ``seed``
    is a draw state of ``draws`` (default ``TorchDraws``), or an int that
    ``draws.key`` turns into one on the components' device."""
    draws = draws or TORCH_DRAWS
    if isinstance(seed, int):
        seed = draws.key(seed, components.device)
    a, b = component_support(components, slack=support_slack)
    if batched:
        return run_batched_oracle(
            components, a, b, seed, k=k, delta=delta, alpha_ef=alpha_ef,
            epsilon=epsilon, block_docs=block_docs,
            block_tokens=block_tokens, draws=draws)
    return run_bandit(components, a, b, seed, k=k, delta=delta,
                      alpha_ef=alpha_ef, epsilon=epsilon, draws=draws)
