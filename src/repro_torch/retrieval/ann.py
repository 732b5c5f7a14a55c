"""Stage-1 candidate generation: per-query-token kNN + ANN-derived bounds
(port of ``repro.retrieval.ann``).

Paper App. A.1: for each query token q_t, retrieve the top-k' most similar
document tokens (exact kNN); the candidate set is the union of owning
documents. Eq. 15 turns the stage-1 similarities into per-(doc, token)
upper bounds:

    a_it = 0
    b_it = h(d_i, t)      if d_i was retrieved for token t  (exact value)
         = s_k'^(t)       otherwise (the k'-th neighbor similarity)

When any token of d_i is in the top-k' for q_t, its best token is too, so
the scatter-max below recovers the exact h(d_i, t) for hit cells. The
(T, C*L) similarity product is a plain matrix product (``torch.matmul``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.bandit import stable_topk

_NEG = -3e38
_SENTINEL = 2 ** 31 - 1


class CandidateSet(NamedTuple):
    doc_ids: torch.Tensor      # (N,) i64, -1 padding
    doc_mask: torch.Tensor     # (N,) bool
    a: torch.Tensor            # (N, T) lower support
    b: torch.Tensor            # (N, T) upper support (Eq. 15)
    known_mask: torch.Tensor   # (N, T) bool — cells whose exact value stage 1 saw
    known_vals: torch.Tensor   # (N, T) f32
    s_kprime: torch.Tensor     # (T,) k'-th neighbor similarity per query token


def generate_candidates(
    index_embs: torch.Tensor,      # (C, L, M)
    index_mask: torch.Tensor,      # (C, L)
    query: torch.Tensor,           # (T, M)
    *,
    kprime: int = 10,
    max_candidates: int = 256,
    support: Tuple[float, float] = (0.0, 1.0),
) -> CandidateSet:
    C, L, M = index_embs.shape
    T = query.shape[0]
    dev = index_embs.device
    kprime = min(kprime, C * L)   # a tiny corpus can't yield k' neighbors
    toks = index_embs.reshape(C * L, M).to(torch.float32)
    owner = torch.arange(C, device=dev).repeat_interleave(L)
    valid = index_mask.reshape(-1)

    sims = query.to(torch.float32) @ toks.T                         # (T, C*L)
    sims = torch.where(valid[None, :], sims, _NEG)
    top_vals, top_idx = stable_topk(sims, kprime)                   # (T, k')
    hit_docs = owner[top_idx]                                       # (T, k')
    s_kprime = top_vals[:, kprime - 1]

    # Candidate set = union of hit docs. If the union exceeds
    # max_candidates, keep the docs with the HIGHEST best-hit similarity.
    doc_best = torch.full((C,), _NEG, device=dev).scatter_reduce(
        0, hit_docs.reshape(-1), top_vals.reshape(-1), "amax")
    best_vals, best_ids = stable_topk(doc_best, min(max_candidates, C))
    if C < max_candidates:               # pad to the static candidate count
        pad = max_candidates - C
        best_vals = torch.cat([best_vals, torch.full((pad,), _NEG,
                                                     device=dev)])
        best_ids = torch.cat([best_ids, torch.zeros((pad,),
                                                    dtype=torch.int64,
                                                    device=dev)])
    sel = best_vals > _NEG / 2
    sorted_slots = torch.sort(torch.where(sel, best_ids, _SENTINEL)).values
    # Keep the sentinel-padded array: it stays ascending, which the
    # searchsorted hit lookup below requires (-1 padding would break the
    # order and silently drop exact b-values for high doc ids).
    cands = torch.where(sorted_slots == _SENTINEL, -1, sorted_slots)
    doc_mask = cands >= 0

    a_lo, b_hi = support
    a = torch.full((max_candidates, T), float(a_lo), device=dev)
    # Default upper bound: the k'-th neighbor similarity per token (Eq. 15).
    b = torch.clamp(s_kprime, min=a_lo)[None, :].expand(
        max_candidates, T).to(torch.float32)

    # Hit cells: exact h value via scatter-max into candidate rows.
    pos = torch.searchsorted(sorted_slots, hit_docs)                # (T, k')
    pos = torch.clamp(pos, 0, max_candidates - 1)
    is_cand = sorted_slots[pos] == hit_docs
    t_grid = torch.arange(T, device=dev)[:, None].expand_as(hit_docs)
    safe_pos = torch.where(is_cand, pos, max_candidates - 1)

    known_vals = torch.full((max_candidates * T,), _NEG, device=dev)
    known_vals = known_vals.scatter_reduce(
        0, (safe_pos * T + t_grid).reshape(-1),
        torch.where(is_cand, top_vals, _NEG).reshape(-1),
        "amax").reshape(max_candidates, T)
    known_mask = known_vals > _NEG / 2
    known_vals = torch.where(known_mask, known_vals, 0.0)

    b = torch.where(known_mask, known_vals, b)
    b = torch.clamp(b, a_lo, b_hi)
    a = torch.where(doc_mask[:, None], a, 0.0)
    b = torch.where(doc_mask[:, None], b, 0.0)

    return CandidateSet(doc_ids=cands, doc_mask=doc_mask, a=a, b=b,
                        known_mask=known_mask & doc_mask[:, None],
                        known_vals=known_vals, s_kprime=s_kprime)


def generic_bounds(n: int, t: int, support: Tuple[float, float] = (0.0, 1.0),
                   *, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """No-ANN fallback: global similarity-range bounds (paper Sec. 5.3)."""
    a = torch.full((n, t), float(support[0]), device=device)
    b = torch.full((n, t), float(support[1]), device=device)
    return a, b
