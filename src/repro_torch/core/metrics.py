"""Ranking-fidelity metric (port of ``repro.core.metrics.overlap_at_k``)."""
from __future__ import annotations

import torch


def overlap_at_k(topk_hat: torch.Tensor,
                 topk_star: torch.Tensor) -> torch.Tensor:
    """Eq. 16: |T_K_star ∩ T_K_hat| / K (index sets, order-insensitive),
    over the last axis; leading axes are a batch."""
    eq = topk_hat[..., :, None] == topk_star[..., None, :]
    return eq.any(dim=-1).to(torch.float32).sum(dim=-1) / topk_hat.shape[-1]
