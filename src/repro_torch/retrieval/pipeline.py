"""Batched two-stage serving pipeline (port of
``repro.retrieval.pipeline.serve_queries``).

Stage 1: per-token kNN candidate generation (+ Eq. 15 bounds).
Stage 2: dense or Col-Bandit rerank through the same service steps.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import BanditConfig
from repro_torch.core.frontier import DrawSource, TorchDraws
from repro_torch.retrieval.ann import CandidateSet, generate_candidates
from repro_torch.retrieval.service import (_require_dense,
                                           rerank_bandit_step,
                                           rerank_dense_step)


@dataclasses.dataclass
class ServeResult:
    """Batched pipeline output (numpy, ready for the caller)."""

    topk_scores: np.ndarray      # (B, K) f32
    topk_ids: np.ndarray         # (B, K) global doc ids, -1 padded
    reveal_fraction: np.ndarray  # (B,) fraction of MaxSim cells computed
    stats: np.ndarray            # (4,) [occupancy, rounds, waste, quarantined]


def candidates_for(embs, mask, queries, *, kprime: int, max_candidates: int,
                   support) -> CandidateSet:
    """Stage 1 for a (B, T, M) query batch, one query at a time so the
    (T, C*L) similarity matrix stays the only large temporary."""
    per_q = [generate_candidates(embs, mask, q, kprime=kprime,
                                 max_candidates=max_candidates,
                                 support=support) for q in queries]
    return CandidateSet(*(torch.stack(f) for f in zip(*per_q)))


def serve_queries(
    index,
    queries,                     # (B, T, M)
    *,
    k: int = 5,
    flavor: str = "bandit",      # "dense" | "bandit"
    kprime: int = 10,
    max_candidates: int = 64,
    bandit: Optional[BanditConfig] = None,
    engine: str = "pooled",
    max_rounds: int = -1,
    seed: int = 0,
    device="cuda",
    draws: Optional[DrawSource] = None,
) -> ServeResult:
    """The batched pipeline entry point: stage-1 kNN + Eq. 15 bounds feeding
    ``service.rerank_dense_step`` / ``rerank_bandit_step``.

    ``index`` is duck-typed: a ``retrieval.index.TokenIndex``
    (``doc_embs``/``doc_mask``), a ``retrieval.corpus.Corpus`` facade, or
    any object exposing ``embs``/``mask``; it must already live on
    ``device``. Stage 1 reads raw rows, so a quantized corpus raises
    ``ValueError`` (serve one through ``service.make_serving_step`` with
    stage-1 candidates from a dense corpus). ``draws`` replaces the default
    ``TorchDraws(seed)`` (the parity tests replay the JAX package's key
    chain through it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    embs = getattr(index, "embs", None)
    mask = getattr(index, "mask", None)
    if embs is None:
        embs, mask = index.doc_embs, index.doc_mask
    _require_dense(embs, "serve_queries' stage-1 kNN")
    where = {embs.device, mask.device}
    if where != {dev}:
        raise ValueError(f"serve_queries: the index is on "
                         f"{sorted(map(str, where))}, the run on {dev}; "
                         f"build it with device={device!r}")
    bandit = bandit or BanditConfig(k=k)
    if not isinstance(queries, torch.Tensor):
        queries = np.asarray(queries, np.float32)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)

    cand = candidates_for(embs, mask, queries, kprime=kprime,
                          max_candidates=max_candidates,
                          support=bandit.support)
    if flavor == "dense":
        scores, gids, frac, stats = rerank_dense_step(
            embs, mask, queries, cand.doc_ids, cand.a, cand.b, topk=k)
    elif flavor == "bandit":
        scores, gids, frac, stats = rerank_bandit_step(
            embs, mask, queries, cand.doc_ids, cand.a, cand.b,
            draws if draws is not None else TorchDraws(seed, dev), topk=k,
            alpha_ef=bandit.alpha_ef, delta=bandit.delta,
            block_docs=bandit.block_docs, block_tokens=bandit.block_tokens,
            max_rounds=max_rounds, engine=engine)
    else:
        raise ValueError(f"unknown serving flavor {flavor!r}")
    return ServeResult(topk_scores=scores.cpu().numpy(),
                       topk_ids=gids.cpu().numpy(),
                       reveal_fraction=frac.cpu().numpy(),
                       stats=stats.cpu().numpy())
