"""Evaluation metrics (paper Sec. 5.1; port of ``repro.core.metrics``).

Overlap@K (Eq. 16) measures ranking fidelity against full scoring;
Recall@K, MRR@K and nDCG@K measure end-task retrieval effectiveness
against relevance labels.
"""
from __future__ import annotations

import torch


def overlap_at_k(topk_hat: torch.Tensor,
                 topk_star: torch.Tensor) -> torch.Tensor:
    """Eq. 16: |T_K_star ∩ T_K_hat| / K (index sets, order-insensitive),
    over the last axis; leading axes are a batch."""
    eq = topk_hat[..., :, None] == topk_star[..., None, :]
    return eq.any(dim=-1).to(torch.float32).sum(dim=-1) / topk_hat.shape[-1]


def recall_at_k(topk: torch.Tensor, relevant: torch.Tensor) -> torch.Tensor:
    """relevant: (N,) bool per candidate. Recall = hits@K / total relevant."""
    hits = relevant[topk].to(torch.float32).sum()
    return hits / torch.clamp(relevant.to(torch.float32).sum(), min=1.0)


def mrr_at_k(topk: torch.Tensor, relevant: torch.Tensor) -> torch.Tensor:
    """Reciprocal rank of the first relevant hit within the top-K list."""
    rel = relevant[topk].to(torch.float32)                 # (K,) rank order
    ranks = torch.arange(1, topk.shape[0] + 1, dtype=torch.float32,
                         device=topk.device)
    rr = rel / ranks
    first = torch.argmax(rel)                              # first hit
    return torch.where((rel > 0).any(), rr[first], 0.0)


def ndcg_at_k(topk: torch.Tensor, relevant: torch.Tensor) -> torch.Tensor:
    """Binary-gain nDCG@K against an ideal ranking of the relevant set."""
    k = topk.shape[0]
    rel = relevant[topk].to(torch.float32)
    discounts = 1.0 / torch.log2(torch.arange(2, k + 2, dtype=torch.float32,
                                              device=topk.device))
    dcg = (rel * discounts).sum()
    n_rel = relevant.to(torch.int64).sum()
    ideal = (torch.arange(k, device=topk.device) < n_rel).to(torch.float32)
    return dcg / torch.clamp((ideal * discounts).sum(), min=1e-9)


def all_metrics(topk_hat: torch.Tensor, topk_star: torch.Tensor,
                relevant: torch.Tensor) -> dict:
    return {
        "overlap": overlap_at_k(topk_hat, topk_star),
        "recall": recall_at_k(topk_hat, relevant),
        "mrr": mrr_at_k(topk_hat, relevant),
        "ndcg": ndcg_at_k(topk_hat, relevant),
    }
