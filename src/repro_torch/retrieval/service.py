"""Single-device rerank steps (port of the serving steps of
``repro.retrieval.service``).

rerank_dense_step
    Exact MaxSim over each query's candidate list through
    ``kernels.ops.maxsim_batch_op`` (the dense scorer kernel).
rerank_bandit_step
    Adaptive Col-Bandit rerank through the pooled frontier engine
    (``core.frontier.run_pooled_bandit``): one reveal launch per round for
    the whole batch, converged queries retired. ``engine="pooled"`` and
    ``"pooled_fused"`` run the fused round body (``fused_reveal`` kernel),
    ``"pooled_chain"`` the chain oracle (``gather_maxsim`` kernel).

``corpus_embs`` may be a compressed corpus (``kernels.quant.QuantTokens``):
the candidates are gathered leaf-wise and the kernels dequantize in place.
Both return ``(topk_scores (B, K), topk_global_ids (B, K), reveal_frac
(B,), stats (4,))`` with stats = [frontier occupancy, total rounds,
lockstep waste, quarantined docs]. Where the JAX steps take a PRNG key,
these take a ``core.frontier.DrawSource``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.bandit import stable_topk
from repro_torch.core.batched import BatchedConfig
from repro_torch.core.frontier import DrawSource, run_pooled_bandit
from repro_torch.kernels.ops import (fused_reveal_op, gather_maxsim_op,
                                     maxsim_batch_op)
from repro_torch.kernels.quant import QuantTokens, corpus_reshape
from repro_torch.retrieval.corpus import gather_tokens

_NEG = -3e38
ENGINES = {"pooled": True, "pooled_fused": True, "pooled_chain": False}


def gather_candidates(corpus_embs, corpus_mask, cand_ids):
    """corpus_embs (C, L, M) or a ``QuantTokens``, corpus_mask (C, L),
    cand_ids (B, N) with -1 padding -> docs (B, N, L, M), dmask (B, N, L)
    (all-False for padding); a quantized corpus is gathered leaf-wise."""
    return gather_tokens(corpus_embs, corpus_mask, cand_ids)


def _require_dense(corpus_embs, where: str):
    """Loud failure where the math needs raw embedding rows (the stage-1
    kNN of ``serve_queries``)."""
    if isinstance(corpus_embs, QuantTokens):
        raise ValueError(
            f"{where} requires a dense (bf16/f32) corpus; got a "
            f"{corpus_embs.fmt!r}-quantized one. Rebuild the corpus with "
            "corpus_format='bf16', or rerank given candidates on it with "
            "make_serving_step('dense' | 'bandit').")


def _local_maxsim_scores(doc_embs, doc_mask, queries):
    """(B, N, L, M) x (B, T, M) -> scores (B, N) = sum_t max_l sims, through
    the dense MaxSim kernel; all-masked candidates score 0."""
    h = maxsim_batch_op(doc_embs, doc_mask, queries)            # (B, N, T)
    h = torch.where(doc_mask.any(dim=2)[:, :, None], h, 0.0)
    return h.sum(dim=-1)


def rerank_dense_step(corpus_embs, corpus_mask, queries, cand_ids, a=None,
                      b=None, draws: Optional[DrawSource] = None, *,
                      topk: int = 10):
    """Exact MaxSim over the candidate list; a/b/draws are accepted and
    ignored so dense and bandit steps are interchangeable. Non-finite
    scores (poisoned corpus rows) are quarantined to the -inf sentinel and
    counted in ``stats[3]``."""
    del a, b, draws
    docs, dmask = gather_candidates(corpus_embs, corpus_mask, cand_ids)
    scores = _local_maxsim_scores(docs, dmask, queries)
    finite = torch.isfinite(scores)
    quar = ((cand_ids >= 0) & ~finite).sum().to(torch.float32)
    scores = torch.where((cand_ids >= 0) & finite, scores, _NEG)
    best, pos = stable_topk(scores, topk)
    gids = torch.gather(cand_ids, 1, pos)
    gids = torch.where(best > _NEG / 2, gids, -1)
    frac = torch.ones((queries.shape[0],), dtype=torch.float32,
                      device=queries.device)
    one, zero = torch.ones_like(quar), torch.zeros_like(quar)
    return best, gids, frac, torch.stack([one, zero, zero, quar])


def _pooled_rerank(docs, dmask, queries, cand_ids, a, b, draws,
                   cfg: BatchedConfig, *, fused: bool):
    """Pooled frontier engine over pre-gathered candidates: stacks the
    (B, N, L, M) candidates to (B*N, L, M) and the query tokens to
    (B*T, M), so every round reveals all queries' blocks in one launch."""
    Bq, N, L, M = docs.shape
    T = queries.shape[1]
    stacked = corpus_reshape(docs, Bq * N)    # quantized: leaf-wise reshape
    stacked_mask = dmask.reshape(Bq * N, L)
    flat_q = queries.reshape(Bq * T, M)

    def cells(flat_doc, flat_tok):
        return gather_maxsim_op(stacked, stacked_mask, flat_q, flat_doc,
                                flat_tok)

    def cells_fused(flat_doc, flat_tok, new_mask):
        return fused_reveal_op(stacked, stacked_mask, flat_q, flat_doc,
                               flat_tok, new_mask)

    res = run_pooled_bandit(cells, a, b, draws, cfg, doc_mask=cand_ids >= 0,
                            compute_cells_fused=cells_fused, fused=fused)
    scores = torch.gather(res.s_hat, 1, res.topk)
    picked = torch.gather(cand_ids, 1, res.topk)
    gids = torch.where(picked >= 0, picked, -1)
    stats = torch.stack([res.occupancy,
                         res.total_rounds.to(torch.float32),
                         res.lockstep_waste.to(torch.float32),
                         res.quarantined.sum().to(torch.float32)])
    return scores, gids, res.coverage, stats


def _engine_fused(engine: str) -> bool:
    try:
        return ENGINES[engine]
    except KeyError:
        raise ValueError(f"unknown reveal engine: {engine!r} "
                         f"(expected one of {sorted(ENGINES)})") from None


def rerank_bandit_step(corpus_embs, corpus_mask, queries, cand_ids, a, b,
                       draws: DrawSource, *, topk: int = 10,
                       alpha_ef: float = 0.3, delta: float = 0.01,
                       block_docs: int = 8, block_tokens: int = 8,
                       max_rounds: int = -1, max_block_docs: int = 0,
                       max_block_tokens: int = 0, engine: str = "pooled"):
    """Adaptive Col-Bandit rerank over the candidate list, all queries
    through one pooled frontier loop."""
    fused = _engine_fused(engine)
    cfg = BatchedConfig(k=topk, delta=delta, alpha_ef=alpha_ef,
                        block_docs=block_docs, block_tokens=block_tokens,
                        max_rounds=max_rounds, max_block_docs=max_block_docs,
                        max_block_tokens=max_block_tokens)
    docs, dmask = gather_candidates(corpus_embs, corpus_mask, cand_ids)
    return _pooled_rerank(docs, dmask, queries, cand_ids, a, b, draws, cfg,
                          fused=fused)


def make_serving_step(flavor: str, *, topk: int = 10, alpha_ef: float = 0.3,
                      delta: float = 0.01, block_docs: int = 8,
                      block_tokens: int = 8, max_rounds: int = -1,
                      max_block_docs: int = 0, max_block_tokens: int = 0,
                      engine: str = "pooled"):
    """Step factory with the uniform step signature
    ``(corpus_embs, corpus_mask, queries, cand_ids, a, b, draws)``."""
    _engine_fused(engine)
    if flavor == "dense":
        return functools.partial(rerank_dense_step, topk=topk)
    if flavor == "bandit":
        return functools.partial(
            rerank_bandit_step, topk=topk, alpha_ef=alpha_ef, delta=delta,
            block_docs=block_docs, block_tokens=block_tokens,
            max_rounds=max_rounds, max_block_docs=max_block_docs,
            max_block_tokens=max_block_tokens, engine=engine)
    raise ValueError(f"unknown serving flavor: {flavor!r}")
