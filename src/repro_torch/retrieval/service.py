"""Single-device rerank steps (port of the engine-facing serving steps of
``repro.retrieval.service``).

rerank_dense_step
    Exact MaxSim over each query's candidate list through
    ``kernels.ops.maxsim_batch_op`` (the dense scorer kernel).
rerank_bandit_step
    Adaptive Col-Bandit rerank. ``engine="pooled"`` and ``"pooled_fused"``
    run the pooled frontier engine (``core.frontier.run_pooled_bandit``)
    with the fused round body (``fused_reveal`` kernel), ``"pooled_chain"``
    with the chain oracle (``gather_maxsim`` kernel): one reveal launch per
    trip for the whole batch, converged queries retired.
    ``engine="vmapped"`` is the lockstep engine: the solo block bandit per
    query over gathered-einsum cells (plain PyTorch), as JAX's vmapped
    ``while_loop``.
make_streaming_step
    The continuous-batching step: a bounded slice of the pooled engine over
    a carried per-slot ``FrontierState``, refilled by the host.

``corpus_embs`` may be a compressed corpus (``kernels.quant.QuantTokens``):
the candidates are gathered leaf-wise and the kernels dequantize in place.
The batch steps share one signature (``make_serving_step``)::

    step(corpus_embs, corpus_mask, queries (B, T, M), cand_ids (B, N),
         a (B, N, T), b (B, N, T), seeds (B, ...),
         [alpha_scale=(), round_cap=()])
      -> (topk_scores (B, K), topk_global_ids (B, K), reveal_frac (B,),
          stats (4,) = [occupancy, total rounds, lockstep waste,
                        quarantined])

Where the JAX steps take PRNG keys, these take per-query seeds of a
``core.draws.DrawSource`` (``draws=``, default ``TorchDraws``). The
fidelity knobs ``alpha_scale`` (float32) and ``round_cap`` (int, <= 0
off) are Python numbers or 0-d tensors on the run's device; omitted, a
step is bit-identical to the knob-less one. Dense and the lockstep engine
accept and ignore them.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.bandit import stable_topk
from repro_torch.core.batched import (BatchedConfig, _max_rounds,
                                      run_batched_bandit)
from repro_torch.core.draws import DrawSource
from repro_torch.core.frontier import (FrontierState, init_frontier_state,
                                       run_pooled_bandit)
from repro_torch.kernels.ops import (fused_reveal_op, gather_maxsim_op,
                                     maxsim_batch_op)
from repro_torch.kernels.quant import QuantTokens, corpus_reshape
from repro_torch.retrieval.corpus import gather_tokens

_NEG = -3e38


def gather_candidates(corpus_embs, corpus_mask, cand_ids):
    """corpus_embs (C, L, M) or a ``QuantTokens``, corpus_mask (C, L),
    cand_ids (B, N) with -1 padding -> docs (B, N, L, M), dmask (B, N, L)
    (all-False for padding); a quantized corpus is gathered leaf-wise."""
    return gather_tokens(corpus_embs, corpus_mask, cand_ids)


def _require_dense(corpus_embs, where: str):
    """Loud failure where the math needs raw embedding rows (the stage-1
    kNN of ``serve_queries``, the lockstep engine's einsum)."""
    if isinstance(corpus_embs, QuantTokens):
        raise ValueError(
            f"{where} requires a dense (bf16/f32) corpus; got a "
            f"{corpus_embs.fmt!r}-quantized one. Rebuild the corpus with "
            "corpus_format='bf16', or rerank given candidates on it with "
            "make_serving_step('dense' | 'bandit') or make_streaming_step.")


def _local_maxsim_scores(doc_embs, doc_mask, queries):
    """(B, N, L, M) x (B, T, M) -> scores (B, N) = sum_t max_l sims, through
    the dense MaxSim kernel; all-masked candidates score 0."""
    h = maxsim_batch_op(doc_embs, doc_mask, queries)            # (B, N, T)
    h = torch.where(doc_mask.any(dim=2)[:, :, None], h, 0.0)
    return h.sum(dim=-1)


def _stacked_cells(docs, dmask, queries):
    """The pooled engine's cell sources over (B, N, L, M) candidates
    stacked to (B*N, L, M) and query tokens stacked to (B*T, M): the chain
    contract (``gather_maxsim``) and the fused one (``fused_reveal``)."""
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

    return cells, cells_fused


def _pooled_outputs(res, cand_ids):
    """(scores, global ids, coverage, stats) of a PooledResult."""
    scores = torch.gather(res.s_hat, 1, res.topk)
    picked = torch.gather(cand_ids, 1, res.topk)
    gids = torch.where(picked >= 0, picked, -1)
    stats = torch.stack([res.occupancy,
                         res.total_rounds.to(torch.float32),
                         res.lockstep_waste.to(torch.float32),
                         res.quarantined.sum().to(torch.float32)])
    return scores, gids, res.coverage, stats


def rerank_dense_step(corpus_embs, corpus_mask, queries, cand_ids, a=None,
                      b=None, seeds=None, *, topk: int = 10, draws=None,
                      alpha_scale=None, round_cap=None):
    """Exact MaxSim over the candidate list; a/b/seeds/draws and the
    fidelity knobs (dense has no fidelity to trade) are accepted and
    ignored so dense and bandit steps are interchangeable. Non-finite
    scores (poisoned corpus rows) are quarantined to the -inf sentinel and
    counted in ``stats[3]``."""
    del a, b, seeds, draws, alpha_scale, round_cap
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


def _pooled_rerank(docs, dmask, queries, cand_ids, a, b, seeds,
                   cfg: BatchedConfig, *, fused: bool, draws=None,
                   prereveal=None, prereveal_vals=None, alpha_scale=None,
                   round_cap=None):
    """Pooled frontier engine over pre-gathered candidates: every trip
    reveals all queries' blocks in one launch on query-offset indices.
    ``prereveal``/``prereveal_vals`` (B, N, T) seed exactly-known cells at
    zero reveal cost; ``alpha_scale``/``round_cap`` are the fidelity
    knobs."""
    cells, cells_fused = _stacked_cells(docs, dmask, queries)
    res = run_pooled_bandit(cells, a, b, seeds, cfg, draws=draws,
                            doc_mask=cand_ids >= 0,
                            compute_cells_fused=cells_fused, fused=fused,
                            prereveal=prereveal,
                            prereveal_vals=prereveal_vals,
                            alpha_scale=alpha_scale, round_cap=round_cap)
    return _pooled_outputs(res, cand_ids)


def _bandit_one_query(cfg: BatchedConfig, draws=None):
    """Per-query Col-Bandit over pre-gathered candidates, the lockstep
    engine's body: (docs_q (N, L, M), dmask_q (N, L), q (T, M), cand_q
    (N,), a_q/b_q (N, T), seed) -> (topk scores (K,), global ids (K,),
    coverage (), rounds ()). The reveal is the gathered MaxSim einsum
    (plain PyTorch, as in JAX)."""

    def one_query(docs_q, dmask_q, q, cand_q, a_q, b_q, seed):
        def cells(doc_idx, tok_idx):
            e = docs_q[doc_idx].to(torch.float32)           # (Bd, L, M)
            m = dmask_q[doc_idx]
            qq = q[tok_idx].to(torch.float32)               # (Bd, G, M)
            sims = torch.einsum("blm,bgm->blg", e, qq)
            sims = torch.where(m[:, :, None], sims, _NEG)
            return sims.max(dim=1).values

        res = run_batched_bandit(cells, a_q, b_q, seed, cfg,
                                 doc_mask=cand_q >= 0, draws=draws)
        picked = cand_q[res.topk]
        return (res.s_hat[res.topk], torch.where(picked >= 0, picked, -1),
                res.coverage, res.rounds)

    return one_query


def _lockstep_stats(rounds: torch.Tensor, quarantined) -> torch.Tensor:
    """(occupancy, total_rounds, lockstep_waste, quarantined) for a lockstep
    run: a vmapped loop executes every query to max(rounds), so waste is
    what the batch paid for already-converged queries."""
    Bq = rounds.shape[0]
    total = rounds.sum()
    paid = torch.clamp(Bq * rounds.max(), min=1)
    return torch.stack([total.to(torch.float32) / paid.to(torch.float32),
                        total.to(torch.float32),
                        (paid - total).to(torch.float32),
                        torch.as_tensor(quarantined, dtype=torch.float32,
                                        device=rounds.device)])


def _vmapped_rerank(docs, dmask, queries, cand_ids, a, b, seeds,
                    cfg: BatchedConfig, *, draws=None, alpha_scale=None,
                    round_cap=None):
    """Lockstep engine: the solo block bandit over each query of the batch
    (JAX vmaps it; a vmapped ``while_loop`` freezes finished queries, so
    its per-query results equal solo runs, and so do these).

    It has no fidelity knobs (accepted for signature parity, ignored) and
    no in-loop quarantine; a final finite-score guard drops any non-finite
    top-K entry to the -inf sentinel."""
    del alpha_scale, round_cap
    _require_dense(docs, "the vmapped lockstep engine")
    one = _bandit_one_query(cfg, draws)
    outs = [one(docs[i], dmask[i], queries[i], cand_ids[i], a[i], b[i],
                seeds[i]) for i in range(queries.shape[0])]
    scores, gids, cov, rounds = (torch.stack(x) for x in zip(*outs))
    bad = ~torch.isfinite(scores)
    scores = torch.where(bad, _NEG, scores)
    gids = torch.where(bad, -1, gids)
    return scores, gids, cov, _lockstep_stats(rounds, bad.sum())


ENGINES = {
    "pooled": functools.partial(_pooled_rerank, fused=True),
    "pooled_fused": functools.partial(_pooled_rerank, fused=True),
    "pooled_chain": functools.partial(_pooled_rerank, fused=False),
    "vmapped": _vmapped_rerank,
}


def _rerank_engine(engine: str):
    try:
        return ENGINES[engine]
    except KeyError:
        raise ValueError(f"unknown reveal engine: {engine!r} "
                         f"(expected one of {sorted(ENGINES)})"
                         ) from None


def _batched_config(topk, alpha_ef, delta, block_docs, block_tokens,
                    max_rounds, max_block_docs, max_block_tokens):
    return BatchedConfig(k=topk, delta=delta, alpha_ef=alpha_ef,
                         block_docs=block_docs, block_tokens=block_tokens,
                         max_rounds=max_rounds, max_block_docs=max_block_docs,
                         max_block_tokens=max_block_tokens)


def rerank_bandit_step(corpus_embs, corpus_mask, queries, cand_ids, a, b,
                       seeds, *, topk: int = 10, alpha_ef: float = 0.3,
                       delta: float = 0.01, block_docs: int = 8,
                       block_tokens: int = 8, max_rounds: int = -1,
                       max_block_docs: int = 0, max_block_tokens: int = 0,
                       engine: str = "pooled",
                       draws: Optional[DrawSource] = None,
                       alpha_scale=None, round_cap=None):
    """Adaptive Col-Bandit rerank over the candidate list. ``seeds`` (B,
    ...) are the queries' seeds for ``draws``. ``engine`` picks the pooled
    frontier (default), its chain body, or the lockstep engine, which
    ignores the fidelity knobs."""
    rerank = _rerank_engine(engine)
    cfg = _batched_config(topk, alpha_ef, delta, block_docs, block_tokens,
                          max_rounds, max_block_docs, max_block_tokens)
    docs, dmask = gather_candidates(corpus_embs, corpus_mask, cand_ids)
    return rerank(docs, dmask, queries, cand_ids, a, b, seeds, cfg,
                  draws=draws, alpha_scale=alpha_scale, round_cap=round_cap)


def make_serving_step(flavor: str, *, topk: int = 10, alpha_ef: float = 0.3,
                      delta: float = 0.01, block_docs: int = 8,
                      block_tokens: int = 8, max_rounds: int = -1,
                      max_block_docs: int = 0, max_block_tokens: int = 0,
                      engine: str = "pooled",
                      draws: Optional[DrawSource] = None):
    """Step factory with the uniform step signature ``(corpus_embs,
    corpus_mask, queries, cand_ids, a, b, seeds, [alpha_scale,
    round_cap])``; ``engine`` picks the bandit reveal engine, dense ignores
    it."""
    _rerank_engine(engine)
    if flavor == "dense":
        return functools.partial(rerank_dense_step, topk=topk)
    if flavor == "bandit":
        return functools.partial(
            rerank_bandit_step, topk=topk, alpha_ef=alpha_ef, delta=delta,
            block_docs=block_docs, block_tokens=block_tokens,
            max_rounds=max_rounds, max_block_docs=max_block_docs,
            max_block_tokens=max_block_tokens, engine=engine, draws=draws)
    raise ValueError(f"unknown serving flavor: {flavor!r}")


# ---------------------------------------------------------------------------
# Continuous batching (slot refill). The batch steps run each batch to
# quiescence; the streaming step runs the pooled bandit ``trip_limit``
# trips per call and hands the packed per-slot state back to the host:
#
#   step(corpus_embs, corpus_mask, queries (B, T, M), cand_ids (B, N),
#        a (B, N, T), b (B, N, T), state (FrontierState), fresh (B,) bool,
#        seeds (B, ...))
#     -> (topk_scores (B, K), topk_global_ids (B, K), reveal_frac (B,),
#         stats (4,), harvest (B,) bool, new_state (FrontierState))
#
# The host harvests slots with ``harvest`` set (their rows are final),
# refills them (new query tokens, candidates, bounds and seeds in those
# rows, ``fresh`` marking them) and calls again with the same shapes.
# Carried slots' rows must be re-presented unchanged.
# ---------------------------------------------------------------------------

def init_stream_state(B: int, N: int, T: int, *,
                      device="cuda") -> FrontierState:
    """All-slots-retired carry for a (B, N-candidate, T-token) streaming
    step, the state a continuous-batching loop starts from."""
    return init_frontier_state(B, N, T, device=device)


def make_streaming_step(*, topk: int = 10, alpha_ef: float = 0.3,
                        delta: float = 0.01, block_docs: int = 8,
                        block_tokens: int = 8, max_rounds: int = -1,
                        max_block_docs: int = 0, max_block_tokens: int = 0,
                        trip_limit: int = 4, fused: bool = True,
                        draws: Optional[DrawSource] = None):
    """Slot-refill serving step factory (bandit flavor only: dense has no
    rounds to slice). ``trip_limit`` is the slice length: how many trips
    one call advances every live slot before the host harvests and
    refills. ``fused`` picks the round body; a stream may alternate."""
    if trip_limit < 1:
        raise ValueError("trip_limit must be >= 1")
    cfg = _batched_config(topk, alpha_ef, delta, block_docs, block_tokens,
                          max_rounds, max_block_docs, max_block_tokens)

    def step(corpus_embs, corpus_mask, queries, cand_ids, a, b, state,
             fresh, seeds):
        docs, dmask = gather_candidates(corpus_embs, corpus_mask, cand_ids)
        cells, cells_fused = _stacked_cells(docs, dmask, queries)
        res, new_state = run_pooled_bandit(
            cells, a, b, seeds, cfg, draws=draws, doc_mask=cand_ids >= 0,
            compute_cells_fused=cells_fused, fused=fused, carry=state,
            fresh=fresh, trip_limit=trip_limit, return_state=True)
        # Harvestable = retired OR round-capped: a slot that exhausts
        # max_rounds without separating must still leave the stream.
        mr = _max_rounds(cfg, cand_ids.shape[1], queries.shape[1])
        harvest = new_state.done | (new_state.rounds >= mr)
        return (*_pooled_outputs(res, cand_ids), harvest, new_state)

    return step
