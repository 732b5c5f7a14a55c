"""Rerank steps (port of ``repro.retrieval.service``): the single-device
engine-facing steps, and below them the mesh half (the corpus split over a
``dist.mesh.Mesh``: the sharded dense, budgeted, two-phase and bandit
steps, the engine's sharded serving step and the routed step with
shard-local stage 1).

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
The pooled engines and the streaming step gather nothing: their reveal
kernels read each revealed doc in place in the resident corpus, by its
global id.
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

import contextlib
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.audit import nbytes, note_collective
from repro_torch.core.bandit import stable_topk
from repro_torch.core.batched import (BatchedConfig, _max_rounds,
                                      run_batched_bandit)
from repro_torch.core.draws import TORCH_DRAWS, DrawSource
from repro_torch.core.frontier import (FrontierState, TripGraphs, as_is,
                                       init_frontier_state,
                                       run_pooled_bandit)
from repro_torch.kernels.ops import (fused_reveal_op, gather_maxsim_op,
                                     maxsim_batch_op)
from repro_torch.dist.mesh import Mesh, shard_parts
from repro_torch.kernels.quant import QuantTokens, corpus_index, \
    corpus_leaves, corpus_reshape
from repro_torch.retrieval.ann import CandidateSet, generate_candidates
from repro_torch.retrieval.corpus import gather_tokens, route_mass, \
    route_quotas

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


def _stacked_cells(embs, mask, queries, cand_ids=None, stage=as_is):
    """The pooled engine's cell sources, the chain contract
    (``gather_maxsim``) and the fused one (``fused_reveal``), over the
    frontier's Q*N candidate rows and query tokens stacked to (Q*T, M).

    With ``cand_ids`` (Q, N), ``embs`` (C, L, M) / ``mask`` (C, L) are the
    resident corpus, read in place: frontier row q*N + i reads corpus row
    ``cand_ids[q, i]``. A padded slot (-1) reads row 0; the frontier keeps
    its cells out of the statistics (``doc_mask``). Without, they are a
    gathered (Q, N, L, M) block and frontier row q*N + i is its own row.
    Either way the launch's tuning bucket counts the Q*N rows. ``stage``
    places the stacked queries and the row ids where a trip graph reads
    them (``core.frontier.TripGraph.stage``)."""
    Q, T, M = queries.shape
    flat_q = stage("flat_q", queries.reshape(Q * T, M))
    if cand_ids is None:
        n_rows, L = embs.shape[0] * embs.shape[1], embs.shape[2]
        src = corpus_reshape(embs, n_rows)    # quantized: leaf-wise reshape
        src_mask = mask.reshape(n_rows, L)

        def rows(flat_doc):
            return flat_doc
    else:
        n_rows = cand_ids.numel()
        src, src_mask = embs, mask
        doc_ids = stage("doc_ids", torch.clamp(cand_ids, min=0).reshape(
            -1).to(torch.int64))

        def rows(flat_doc):
            return doc_ids[flat_doc]

    def cells(flat_doc, flat_tok):
        return gather_maxsim_op(src, src_mask, flat_q, rows(flat_doc),
                                flat_tok, doc_rows=n_rows)

    def cells_fused(flat_doc, flat_tok, new_mask):
        return fused_reveal_op(src, src_mask, flat_q, rows(flat_doc),
                               flat_tok, new_mask, doc_rows=n_rows)

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


def _graph_key(docs, dmask, queries, a, cfg: BatchedConfig, draws,
               alpha_scale) -> Optional[tuple]:
    """A fused in-place run's trip-graph key: the batch shape (Q, N, T, M)
    and dtype, the config (so W, G_cap, F and the compaction), the draw
    source, the resident corpus it reads (a graph holds its addresses) and
    the alpha scale, which a trip reads as a host scalar and a capture
    bakes in. None where the scale is a device tensor (never read here):
    such a run stays eager."""
    if isinstance(alpha_scale, torch.Tensor):
        if alpha_scale.device.type != "cpu":
            return None
        alpha_scale = float(alpha_scale)
    corpus = tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                   for t in (*corpus_leaves(docs), dmask))
    return (tuple(a.shape), tuple(queries.shape), queries.dtype, cfg, draws,
            1.0 if alpha_scale is None else float(alpha_scale), corpus)


def _pooled_rerank(docs, dmask, queries, cand_ids, a, b, seeds,
                   cfg: BatchedConfig, *, fused: bool, in_place=False,
                   draws=None, prereveal=None, prereveal_vals=None,
                   alpha_scale=None, round_cap=None,
                   trip_graphs: Optional[TripGraphs] = None):
    """Pooled frontier engine: every trip reveals all queries' blocks in
    one launch on query-offset indices. ``docs``/``dmask`` are the gathered
    (B, N, L, M) candidates, or with ``in_place`` the resident corpus,
    read by ``cand_ids`` (:func:`_stacked_cells`).
    ``prereveal``/``prereveal_vals`` (B, N, T) seed exactly-known cells at
    zero reveal cost; ``alpha_scale``/``round_cap`` are the fidelity
    knobs. A fused in-place run launches its trips through ``trip_graphs``
    where that holds a graph of its key (:class:`core.frontier.TripGraphs`,
    :func:`_graph_key`)."""
    key = (_graph_key(docs, dmask, queries, a, cfg, draws, alpha_scale)
           if trip_graphs is not None and fused and in_place else None)
    with (trip_graphs.use(key, queries.device) if key is not None
          else contextlib.nullcontext()) as graph:
        if graph is None:
            cells, cells_fused = _stacked_cells(
                docs, dmask, queries, cand_ids if in_place else None)
        else:
            cells, cells_fused = _stacked_cells(docs, dmask, queries,
                                                cand_ids, stage=graph.stage)
        res = run_pooled_bandit(cells, a, b, seeds, cfg, draws=draws,
                                doc_mask=cand_ids >= 0,
                                compute_cells_fused=cells_fused, fused=fused,
                                prereveal=prereveal,
                                prereveal_vals=prereveal_vals,
                                alpha_scale=alpha_scale, round_cap=round_cap,
                                graph=graph)
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
                       alpha_scale=None, round_cap=None,
                       trip_graphs: Optional[TripGraphs] = None):
    """Adaptive Col-Bandit rerank over the candidate list. ``seeds`` (B,
    ...) are the queries' seeds for ``draws``. ``engine`` picks the pooled
    frontier (default), its chain body, or the lockstep engine, which
    ignores the fidelity knobs. The pooled engines read the revealed docs
    in place in the resident corpus; the lockstep engine's einsum takes
    the gathered candidates. ``trip_graphs`` is the step's cache of
    captured fused trips (:class:`core.frontier.TripGraphs`)."""
    rerank = _rerank_engine(engine)
    cfg = _batched_config(topk, alpha_ef, delta, block_docs, block_tokens,
                          max_rounds, max_block_docs, max_block_tokens)
    kw = dict(draws=draws, alpha_scale=alpha_scale, round_cap=round_cap)
    if engine == "vmapped":
        docs, dmask = gather_candidates(corpus_embs, corpus_mask, cand_ids)
        return rerank(docs, dmask, queries, cand_ids, a, b, seeds, cfg, **kw)
    return rerank(corpus_embs, corpus_mask, queries, cand_ids, a, b, seeds,
                  cfg, in_place=True, trip_graphs=trip_graphs, **kw)


def make_serving_step(flavor: str, *, topk: int = 10, alpha_ef: float = 0.3,
                      delta: float = 0.01, block_docs: int = 8,
                      block_tokens: int = 8, max_rounds: int = -1,
                      max_block_docs: int = 0, max_block_tokens: int = 0,
                      engine: str = "pooled",
                      draws: Optional[DrawSource] = None,
                      trip_graphs: Optional[TripGraphs] = None):
    """Step factory with the uniform step signature ``(corpus_embs,
    corpus_mask, queries, cand_ids, a, b, seeds, [alpha_scale,
    round_cap])``; ``engine`` picks the bandit reveal engine, dense ignores
    it. ``trip_graphs`` (bandit) launches the fused body's trips of the
    shapes it has captured as CUDA graphs."""
    _rerank_engine(engine)
    if flavor == "dense":
        return functools.partial(rerank_dense_step, topk=topk)
    if flavor == "bandit":
        return functools.partial(
            rerank_bandit_step, topk=topk, alpha_ef=alpha_ef, delta=delta,
            block_docs=block_docs, block_tokens=block_tokens,
            max_rounds=max_rounds, max_block_docs=max_block_docs,
            max_block_tokens=max_block_tokens, engine=engine, draws=draws,
            trip_graphs=trip_graphs)
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
        cells, cells_fused = _stacked_cells(corpus_embs, corpus_mask,
                                            queries, cand_ids)
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


# ---------------------------------------------------------------------------
# Mesh-sharded steps (the shard_map half of ``repro.retrieval.service``).
#
# The corpus lives on a ``dist.mesh.Mesh`` split over every axis
# (``retrieval.sharded.ShardedCorpus``). Where JAX's ``shard_map`` runs one
# program per device, these steps loop over the shards in row-major mesh
# order and run each shard's function on that shard's device; the
# collectives are copies to the merge device (``mesh.devices[0]``): the
# scorecard all-gather is a shard-major ``torch.cat`` and ``psum`` a sum in
# shard order. Every shard scores or reranks only its own resident
# candidates, so the only cross-shard traffic is K-sized scorecards.
#
# The engine-facing sharded steps share one signature:
#
#   step(corpus_embs (C_pad, L, M), corpus_mask (C_pad, L),
#        queries (B, T, M), cand_local (B, n_shards, N_loc),
#        a_local/b_local (B, n_shards, N_loc, T), valid_docs (n_shards,),
#        seed, [healthy (n_shards,) bool, alpha_scale, round_cap])
#     -> (topk_scores (B, K), topk_global_ids (B, K), reveal_frac (B,),
#         stats (n_shards, 4))
#
# ``stats`` is the [occupancy, total rounds, lockstep waste, quarantined]
# vector per shard; ``healthy`` masks failed shards out of the merge (their
# candidates become pads); the knobs are those of the flat steps.
# ---------------------------------------------------------------------------

def _shard_index(mesh: Mesh, coords) -> int:
    """Linear position of the shard at per-axis ``coords`` in the
    row-major mesh order: the doc-dim block the placement assigns it, and
    its place in ``mesh.devices``."""
    ix, mul = 0, 1
    for ax in reversed(mesh.axis_names):
        ix += mul * int(coords[ax])
        mul *= mesh.shape[ax]
    return ix


def _shards(mesh: Mesh):
    """(shard index, device) of every shard: the loop that stands in for
    ``shard_map``'s one program per device. ``mesh.devices`` is in
    row-major order, so shard ``s`` is the ``s``-th device."""
    return enumerate(mesh.devices)


def _host_ints(x) -> list:
    if isinstance(x, torch.Tensor):
        return [int(v) for v in x.reshape(-1).tolist()]
    return [int(v) for v in np.asarray(x).reshape(-1)]


def _host_healthy(healthy, n_shards: int) -> list:
    if healthy is None:
        return [True] * n_shards
    h = (healthy.reshape(-1).tolist() if isinstance(healthy, torch.Tensor)
         else np.asarray(healthy, bool).reshape(-1).tolist())
    if len(h) != n_shards:
        raise ValueError(f"healthy has {len(h)} entries for {n_shards} "
                         "shards")
    return [bool(v) for v in h]


def _shard_global_ids(cand, c_loc: int, shard_ix: int, valid_docs=None):
    """Shard-local candidate slot -> global doc id.

    ``valid_docs`` is the ragged-tail table (``ShardedCorpus.valid_docs``,
    host ints): shard ``s`` owns only ``valid_docs[s]`` of its ``c_loc``
    padded rows, so a slot past that count maps to -1 instead of a
    padded-tail global id (which would score the zero embedding). ``None``
    keeps the every-shard-full contract."""
    owned = c_loc if valid_docs is None else int(valid_docs[shard_ix])
    ok = (cand >= 0) & (cand < owned)
    return torch.where(ok, cand + shard_ix * c_loc, -1)


def _merge_scorecards(scores, gids, topk: int, device):
    """Per-shard scorecards -> the global top-K on ``device``.

    Each shard first reduces its (B, N_loc) scorecard to its local top-K (a
    slot outside a shard's own top-K cannot make the global one), with pad
    entries (gid < 0) at the -3e38 sentinel so a pad's raw score can never
    outrank a real negative one. The global top-K is then taken over the
    shard-major concatenation (JAX's tiled all-gather order), lower index
    first on ties; a shortfall of real candidates returns -1 ids."""
    cards_s, cards_g = [], []
    for sc, g in zip(scores, gids):
        sc = torch.where(g >= 0, sc, _NEG)
        if sc.shape[1] > topk:
            sc, pos = stable_topk(sc, topk)
            g = torch.gather(g, 1, pos)
        # The scorecards are the merge's all-gather (what the audit counts):
        # ids cross as int32, as JAX's s32 gids (every id is < 2**31).
        g = g.to(torch.int32)
        note_collective("all-gather", nbytes(sc, g))
        cards_s.append(sc.to(device))
        cards_g.append(g.to(device))
    all_g = torch.cat(cards_g, dim=1)
    all_s = torch.where(all_g >= 0, torch.cat(cards_s, dim=1), _NEG)
    best, pos = stable_topk(all_s, topk)
    ids = torch.gather(all_g, 1, pos).to(gids[0].dtype)
    return best, torch.where(best > _NEG / 2, ids, -1)


def _chunked_over_queries(score_chunk, args, chunk: int = 512):
    """Run ``score_chunk`` over the query batch in chunks of ``chunk``
    queries so the gathered-docs working set stays bounded; one call when
    the batch does not divide evenly. ``score_chunk`` must return one 2-D
    (chunk, n_scores) tensor per chunk: anything else raises, since the
    scorecard merge would mis-read extra axes."""
    B = args[0].shape[0]
    chunk = min(B, chunk)
    if B % chunk == 0 and B > chunk:
        outs = [score_chunk(tuple(x[i:i + chunk] for x in args))
                for i in range(0, B, chunk)]
        bad = [tuple(o.shape) for o in outs if o.dim() != 2]
        if bad:
            raise ValueError(
                "_chunked_over_queries: score_chunk must return a single "
                f"2-D (chunk, n_scores) tensor per chunk; got {bad[0]}. "
                "Return diagnostics through a separate un-chunked path "
                "instead.")
        return torch.cat(outs)
    out = score_chunk(args)
    if out.dim() != 2:
        raise ValueError(
            "_chunked_over_queries: score_chunk must return a 2-D "
            f"(batch, n_scores) tensor; got shape {tuple(out.shape)}.")
    return out


def _corpus_parts(mesh: Mesh, corpus_embs, corpus_mask,
                  corpus_format: Optional[str] = None):
    """Each shard's local corpus and mask; checks the resident format."""
    embs_p = shard_parts(corpus_embs, mesh)
    mask_p = shard_parts(corpus_mask, mesh)
    if corpus_format is not None:
        got = (embs_p[0].fmt if isinstance(embs_p[0], QuantTokens)
               else "bf16")
        if got != corpus_format:
            raise ValueError(f"the step was built for a {corpus_format!r} "
                             f"corpus and got a {got!r} one")
    return embs_p, mask_p


def _routed_width(cand_local, n_shards: int):
    B, S, NL = cand_local.shape
    if S != n_shards:
        raise ValueError(f"cand_local routed for {S} shards on a "
                         f"{n_shards}-shard mesh")
    return B, NL


def make_rerank_dense_step(mesh: Mesh, *, topk: int = 10, valid_docs=None,
                           corpus_format: str = "bf16"):
    """Sharded exact rerank: step(corpus_embs, corpus_mask, queries (B, T,
    M), cand_local (B, n_shards, N_loc) local slots, -1 pad) ->
    (topk_scores (B, K), topk_ids (B, K) global ids). Each shard gathers
    its resident candidates and runs the dense ``maxsim`` kernel;
    ``valid_docs`` is the ragged-tail table (omit it for an exactly
    divisible corpus); ``corpus_format`` must match the resident corpus."""
    vd = None if valid_docs is None else _host_ints(valid_docs)

    def step(corpus_embs, corpus_mask, queries, cand_local):
        embs_p, mask_p = _corpus_parts(mesh, corpus_embs, corpus_mask,
                                       corpus_format)
        _routed_width(cand_local, mesh.size)
        scores, gids = [], []
        for s, dev in _shards(mesh):
            c_embs, c_mask = embs_p[s], mask_p[s]
            cand = cand_local[:, s].to(dev, torch.int64)
            g = _shard_global_ids(cand, c_mask.shape[0], s, vd)

            def score_chunk(args, c_embs=c_embs, c_mask=c_mask):
                q_c, cand_c = args
                docs, dmask = gather_candidates(c_embs, c_mask, cand_c)
                return _local_maxsim_scores(docs, dmask, q_c)

            sc = _chunked_over_queries(score_chunk, (queries.to(dev), cand))
            scores.append(torch.where(g >= 0, sc, _NEG))
            gids.append(g)
        return _merge_scorecards(scores, gids, topk, mesh.devices[0])

    return step


def _budgeted_scores(docs, dmask, queries, toks):
    """Budgeted MaxSim over the selected query tokens through the
    ``gather_maxsim`` kernel: docs (b, N, L, M), dmask (b, N, L), queries
    (b, T, M), toks (b, N, G') -> scores (b, N), the sum over the G'
    selected cells. Token ids index the stacked (b*T, M) query table;
    they are clamped to [0, T) before the query offset, so a -1 pad cannot
    land on the previous query's last token."""
    b, N, L, M = docs.shape
    T = queries.shape[1]
    G = toks.shape[-1]
    doc_idx = torch.arange(b * N, device=docs.device)
    tok_flat = (torch.clamp(toks.reshape(b * N, G).to(torch.int64), 0, T - 1)
                + (doc_idx // N * T)[:, None])
    h = gather_maxsim_op(docs.reshape(b * N, L, M), dmask.reshape(b * N, L),
                         queries.reshape(b * T, M), doc_idx, tok_flat)
    h = h.reshape(b, N, G)                                 # -3e38 where no
    h = torch.where(dmask.any(dim=2)[:, :, None], h, 0.0)  # valid doc token
    return h.sum(dim=-1)


def make_rerank_budgeted_step(mesh: Mesh, *, topk: int = 10,
                              tokens_per_doc: int = 10, valid_docs=None):
    """The paper's pruning inside the sharded step: the layout of
    :func:`make_rerank_dense_step`, but each (query, candidate) pair scores
    only the ``tokens_per_doc`` query tokens given in ``tok_idx`` (B,
    n_shards, N_loc, G'), through ``gather_maxsim``. Dense corpora only."""
    del tokens_per_doc            # the width is tok_idx's last dim
    vd = None if valid_docs is None else _host_ints(valid_docs)

    def step(corpus_embs, corpus_mask, queries, cand_local, tok_idx):
        embs_p, mask_p = _corpus_parts(mesh, corpus_embs, corpus_mask)
        _require_dense(embs_p[0], "the budgeted serving step")
        _routed_width(cand_local, mesh.size)
        scores, gids = [], []
        for s, dev in _shards(mesh):
            c_embs, c_mask = embs_p[s], mask_p[s]
            cand = cand_local[:, s].to(dev, torch.int64)
            toks = tok_idx[:, s].to(dev)
            g = _shard_global_ids(cand, c_mask.shape[0], s, vd)

            def score_chunk(args, c_embs=c_embs, c_mask=c_mask):
                q_c, cand_c, tok_c = args
                docs, dmask = gather_candidates(c_embs, c_mask, cand_c)
                return _budgeted_scores(docs, dmask, q_c, tok_c)

            sc = _chunked_over_queries(score_chunk,
                                       (queries.to(dev), cand, toks))
            scores.append(torch.where(g >= 0, sc, _NEG))
            gids.append(g)
        return _merge_scorecards(scores, gids, topk, mesh.devices[0])

    return step


def make_rerank_two_phase_step(mesh: Mesh, *, topk: int = 10,
                               survivors: int = 2, valid_docs=None):
    """PLAID-style two-phase scoring: phase 1 screens each shard's
    candidates on a pooled (M,) doc summary (sum_t <q_t, pooled_d>, a plain
    (b, N, M) product with no token axis, so a torch product as in JAX);
    the top ``survivors`` per (query, shard) get exact MaxSim on the
    ``maxsim`` kernel (phase 2). Non-survivors keep their phase-1 score,
    scaled by 1e-3, in the merge. step(corpus_embs, corpus_mask,
    corpus_pooled (C_pad, M), queries, cand_local). Dense corpora only."""
    vd = None if valid_docs is None else _host_ints(valid_docs)

    def step(corpus_embs, corpus_mask, corpus_pooled, queries, cand_local):
        embs_p, mask_p = _corpus_parts(mesh, corpus_embs, corpus_mask)
        _require_dense(embs_p[0], "the two-phase serving step")
        pool_p = shard_parts(corpus_pooled, mesh)
        _routed_width(cand_local, mesh.size)
        scores, gids = [], []
        for s, dev in _shards(mesh):
            c_embs, c_mask, c_pool = embs_p[s], mask_p[s], pool_p[s]
            cand = cand_local[:, s].to(dev, torch.int64)
            g = _shard_global_ids(cand, c_mask.shape[0], s, vd)

            def score_chunk(args, c_embs=c_embs, c_mask=c_mask,
                            c_pool=c_pool):
                q_c, cand_c = args
                # phase 1: pooled screening (M values per doc)
                pooled = c_pool[torch.clamp(cand_c, min=0)]
                q_sum = q_c.to(torch.float32).sum(dim=1)
                s1 = torch.einsum("bnm,bm->bn", pooled.to(torch.float32),
                                  q_sum)
                s1 = torch.where(cand_c >= 0, s1, _NEG)
                # phase 2: exact MaxSim for the survivors only
                _, surv_pos = stable_topk(s1, survivors)
                surv_ids = torch.gather(cand_c, 1, surv_pos)
                docs, dmask = gather_candidates(c_embs, c_mask, surv_ids)
                s2 = _local_maxsim_scores(docs, dmask, q_c)
                s2 = torch.where(surv_ids >= 0, s2, _NEG)
                # exact scores override the phase-1 proxies
                return (s1 * 1e-3).scatter(1, surv_pos, s2)

            scores.append(_chunked_over_queries(score_chunk,
                                                (queries.to(dev), cand)))
            gids.append(g)
        return _merge_scorecards(scores, gids, topk, mesh.devices[0])

    return step


def _knob_kwargs(alpha_scale, round_cap) -> dict:
    """The fidelity knobs a shard's rerank takes: none when both are
    omitted (the knob-less run), else both, the omitted one at its neutral
    value."""
    if alpha_scale is None and round_cap is None:
        return {}
    return dict(alpha_scale=1.0 if alpha_scale is None else alpha_scale,
                round_cap=0 if round_cap is None else round_cap)


def _shard_seeds(draws, base_seed: int, seed, shard_ix: int, B: int, dev):
    """The (batch, shard) seeds: ``split(fold_in(fold_in(key(base_seed),
    seed), shard), B)``, so every (batch, shard) pair reveals its own
    trajectory and the step is a function of (base_seed, seed, inputs)."""
    if isinstance(seed, torch.Tensor):
        seed = int(seed)
    key = draws.fold_in(draws.fold_in(draws.key(base_seed, dev), seed),
                        shard_ix)
    return draws.split(key, B)


def _dense_scorecard(docs, dmask, q, gids, valid, k_shard):
    """A shard's dense scorecard: exact scores of its valid candidates,
    non-finite ones quarantined (counted, sent to the sentinel)."""
    s = _local_maxsim_scores(docs, dmask, q)
    finite = torch.isfinite(s)
    quar = (valid & ~finite).sum().to(torch.float32)
    s = torch.where(valid & finite, s, _NEG)
    best, pos = stable_topk(s, k_shard)
    one, zero = torch.ones_like(quar), torch.zeros_like(quar)
    return best, torch.gather(gids, 1, pos), torch.stack([one, zero, zero,
                                                          quar])


def make_sharded_serving_step(mesh: Mesh, flavor: str, *, topk: int = 10,
                              alpha_ef: float = 0.3, delta: float = 0.01,
                              block_docs: int = 8, block_tokens: int = 8,
                              max_rounds: int = -1, max_block_docs: int = 0,
                              max_block_tokens: int = 0,
                              engine: str = "pooled", base_seed: int = 0,
                              corpus_format: str = "bf16",
                              draws: Optional[DrawSource] = None):
    """Corpus-resident sharded serving step (dense | bandit) with the
    signature above. Each shard scores (``maxsim``/``maxsim_q``) or
    pooled-reranks (``fused_reveal``/``fused_reveal_q``) its own routed
    candidates in its own pooled loop, with seeds from
    :func:`_shard_seeds` on ``draws`` (default ``TorchDraws``).
    ``corpus_format`` must match the resident corpus."""
    n_shards = mesh.size
    if flavor not in ("dense", "bandit"):
        raise ValueError(f"unknown sharded serving flavor: {flavor!r}")
    rerank = _rerank_engine(engine)
    draws = draws or TORCH_DRAWS

    def step(corpus_embs, corpus_mask, queries, cand_local, a_local,
             b_local, valid_docs, seed, healthy=None, alpha_scale=None,
             round_cap=None):
        B, NL = _routed_width(cand_local, n_shards)
        T = queries.shape[1]
        k_shard = min(topk, NL)
        if n_shards * k_shard < topk:
            raise ValueError(
                f"cannot assemble a global top-{topk} from {n_shards} "
                f"shards x {k_shard} candidate slots; raise N_loc")
        cfg = _batched_config(k_shard, alpha_ef, delta, block_docs,
                              block_tokens, max_rounds, max_block_docs,
                              max_block_tokens)
        embs_p, mask_p = _corpus_parts(mesh, corpus_embs, corpus_mask,
                                       corpus_format)
        vd = _host_ints(valid_docs)
        hl = _host_healthy(healthy, n_shards)
        kw = _knob_kwargs(alpha_scale, round_cap)
        cards, n_revs, n_cellss, stats = [], [], [], []
        for s, dev in _shards(mesh):
            c_embs, c_mask = embs_p[s], mask_p[s]
            q = queries.to(dev)
            cand = cand_local[:, s].to(dev, torch.int64)
            gids = _shard_global_ids(cand, c_mask.shape[0], s, vd)
            # A failed shard contributes nothing: its candidates become
            # pads, so the merge masks them and the reveal fraction counts
            # only the healthy corpus.
            valid = (gids >= 0) & hl[s]
            gids = torch.where(valid, gids, -1)
            docs, dmask = gather_candidates(c_embs, c_mask, cand)
            dmask = dmask & valid[:, :, None]
            n_cells = (valid.sum(dim=1) * T).to(torch.float32)
            if flavor == "dense":
                best, bg, st = _dense_scorecard(docs, dmask, q, gids, valid,
                                                k_shard)
                n_rev = n_cells
            else:
                best, bg, cov, st = rerank(
                    docs, dmask, q, gids, a_local[:, s].to(dev),
                    b_local[:, s].to(dev),
                    _shard_seeds(draws, base_seed, seed, s, B, dev), cfg,
                    draws=draws, **kw)
                n_rev = cov * n_cells
            cards.append((best, bg))
            n_revs.append(n_rev)
            n_cellss.append(n_cells)
            stats.append(st)
        return _sharded_outputs(mesh, topk, cards, n_revs, n_cellss, stats)

    return step


def _sharded_outputs(mesh: Mesh, topk: int, cards, n_revs, n_cellss, stats):
    """Merge per-shard results on the merge device: the scorecard merge,
    the reveal fraction from the shard-order sums (psum) of revealed and
    total cells, and the (n_shards, ...) stats."""
    merge = mesh.devices[0]
    note_collective("all-reduce", nbytes(n_revs[0], n_cellss[0]))
    tot_rev = functools.reduce(torch.add, (x.to(merge) for x in n_revs))
    tot_cells = functools.reduce(torch.add, (x.to(merge) for x in n_cellss))
    frac = tot_rev / torch.clamp(tot_cells, min=1.0)
    best, ids = _merge_scorecards([c[0] for c in cards],
                                  [c[1] for c in cards], topk, merge)
    return best, ids, frac, torch.stack([x.to(merge) for x in stats])


def make_rerank_bandit_step(mesh: Mesh, *, topk: int = 10,
                            alpha_ef: float = 0.3, delta: float = 0.01,
                            block_docs: int = 16, block_tokens: int = 8,
                            max_rounds: int = 64, max_block_docs: int = 0,
                            max_block_tokens: int = 0,
                            engine: str = "pooled",
                            placement: str = "query", base_seed: int = 0,
                            corpus_format: str = "bf16",
                            draws: Optional[DrawSource] = None):
    """The Col-Bandit over a mesh; ``placement`` picks the resident side.

    * ``"query"`` (default): the batch splits over the shards (B must
      divide by their number); each shard runs one pooled loop over its
      queries' pre-gathered candidates with their slice of the global keys
      ``split(key(0), B)``. Returns ``(step, in_specs, out_specs)``, the
      specs as placements (the split dim of each operand and output):
      ``step(docs (B, N, L, M), dmask, queries, cand_ids, a, b) ->
      (topk_global_ids (B, K), coverage (B,))``. Per query this equals
      the one-loop run over the whole batch when growth is off
      (``max_block_* = 0``).
    * ``"corpus"``: :func:`make_sharded_serving_step`'s bandit flavor."""
    if placement == "corpus":
        return make_sharded_serving_step(
            mesh, "bandit", topk=topk, alpha_ef=alpha_ef, delta=delta,
            block_docs=block_docs, block_tokens=block_tokens,
            max_rounds=max_rounds, max_block_docs=max_block_docs,
            max_block_tokens=max_block_tokens, engine=engine,
            base_seed=base_seed, corpus_format=corpus_format, draws=draws)
    if placement != "query":
        raise ValueError(f"unknown placement: {placement!r} "
                         "(expected 'query' or 'corpus')")
    cfg = _batched_config(topk, alpha_ef, delta, block_docs, block_tokens,
                          max_rounds, max_block_docs, max_block_tokens)
    rerank = _rerank_engine(engine)
    draws = draws or TORCH_DRAWS

    def step(docs, dmask, queries, cand_ids, a, b):
        B = queries.shape[0]
        if B % mesh.size:
            raise ValueError(f"a batch of {B} queries does not split over "
                             f"{mesh.size} shards")
        bs = B // mesh.size
        keys = draws.keys(0, B, queries.device)
        gids, cov = [], []
        for s, dev in _shards(mesh):
            rows = slice(s * bs, (s + 1) * bs)
            part = [x[rows].to(dev) for x in (dmask, queries, cand_ids, a, b,
                                               keys)]
            d = corpus_index(docs, rows).to(dev)
            _, g, c, _ = rerank(d, part[0], part[1], part[2], part[3],
                                part[4], part[5], cfg, draws=draws)
            gids.append(g.to(mesh.devices[0]))
            cov.append(c.to(mesh.devices[0]))
        return torch.cat(gids), torch.cat(cov)

    in_specs = (0, 0, 0, 0, 0, 0)     # docs, dmask, queries, cand_ids, a, b
    out_specs = (0, 0)
    return step, in_specs, out_specs


# ---------------------------------------------------------------------------
# Routed step: shard-local stage 1 + rerank in one sharded step.
#
#   step(corpus_embs, corpus_mask, centroids (Kc, M), shard_mass (Kc, S),
#        queries (B, T, M), valid_docs (S,), seed,
#        [healthy (S,) bool, alpha_scale, round_cap])
#     -> (topk_scores (B, K), topk_global_ids (B, K), reveal_frac (B,),
#         stats (S, 6))
#
# ``stats`` = [occupancy, total rounds, lockstep waste, mean quota share,
# max quota share, quarantined] per shard (quarantine last). Every shard
# runs the replicated centroid router over the whole batch (the same quota
# table everywhere), caps its own stage-1 kNN at its quota column when
# ``n_total > 0`` and feeds its CandidateSet (Eq. 15 bounds included) to
# the scorer; ``healthy`` re-routes a failed shard's quota mass.
# ---------------------------------------------------------------------------

def make_routed_serving_step(mesh: Mesh, flavor: str = "bandit", *,
                             topk: int = 10, n_local: int = 16,
                             n_total: int = 0, kprime: int = 8,
                             support: Tuple[float, float] = (0.0, 1.0),
                             prereveal_ann: bool = False,
                             alpha_ef: float = 0.3, delta: float = 0.01,
                             block_docs: int = 8, block_tokens: int = 8,
                             max_rounds: int = -1, max_block_docs: int = 0,
                             max_block_tokens: int = 0,
                             engine: str = "pooled", base_seed: int = 0,
                             corpus_format: str = "bf16",
                             draws: Optional[DrawSource] = None):
    """Shard-local stage-1 serving step (dense | bandit), centroid-routed.
    Dense corpora only: shard-local stage 1 scans raw token rows. Quotas
    are not validated here: shard-local stage 1 only emits docs the shard
    hit, so an over-quota shard yields fewer candidates, never a wrong id.
    ``prereveal_ann`` seeds the bandit with the stage-1 hit cells (free
    reveals, not counted as work). Seeds as in
    :func:`make_sharded_serving_step`."""
    n_shards = mesh.size
    if flavor not in ("dense", "bandit"):
        raise ValueError(f"unknown routed serving flavor: {flavor!r}")
    if corpus_format != "bf16":
        raise ValueError(
            "the routed serving step requires a dense (bf16/f32) corpus: "
            "shard-local stage-1 kNN scans raw token rows, which a "
            f"{corpus_format!r}-compressed corpus does not expose. Use "
            "make_sharded_serving_step (host-routed) for quantized "
            "corpora.")
    rerank = _rerank_engine(engine)
    if prereveal_ann and engine == "vmapped":
        raise ValueError("prereveal_ann requires a pooled reveal engine "
                         "(the vmapped lockstep path has no prereveal)")
    k_shard = min(topk, n_local)
    if n_shards * k_shard < topk:
        raise ValueError(
            f"cannot assemble a global top-{topk} from {n_shards} shards "
            f"x {k_shard} candidate slots; raise n_local")
    cfg = _batched_config(k_shard, alpha_ef, delta, block_docs, block_tokens,
                          max_rounds, max_block_docs, max_block_tokens)
    draws = draws or TORCH_DRAWS

    def step(corpus_embs, corpus_mask, centroids, shard_mass, queries,
             valid_docs, seed, healthy=None, alpha_scale=None,
             round_cap=None):
        embs_p, mask_p = _corpus_parts(mesh, corpus_embs, corpus_mask,
                                       corpus_format)
        vd = _host_ints(valid_docs)
        hl = _host_healthy(healthy, n_shards)
        knob = _knob_kwargs(alpha_scale, round_cap)
        B, T = queries.shape[0], queries.shape[1]
        cards, n_revs, n_cellss, stats = [], [], [], []
        for s, dev in _shards(mesh):
            c_embs, c_mask = embs_p[s], mask_p[s]
            q = queries.to(dev)
            # Centroid routing: the same quota table on every shard, each
            # reading its own column; a failed shard's mass is re-routed.
            m = route_mass(q, centroids.to(dev), shard_mass.to(dev))
            if n_total:
                quota = route_quotas(
                    m, n_total, healthy=None if healthy is None else
                    torch.as_tensor(hl, device=dev))
                my_quota = quota[:, s]
                share = quota.to(torch.float32) / n_total
            else:
                my_quota = None
                share = torch.full((B, n_shards), 1.0 / n_shards,
                                   dtype=torch.float32, device=dev)
            my_share = share[:, s]
            # Shard-local stage 1 over this shard's own (C_loc * L, M)
            # tokens; pad rows are all-masked and never become candidates.
            cand = CandidateSet(*(torch.stack(f) for f in zip(*(
                generate_candidates(
                    c_embs, c_mask, q[i],
                    None if my_quota is None else my_quota[i],
                    kprime=kprime, max_candidates=n_local, support=support)
                for i in range(B)))))
            gids = _shard_global_ids(cand.doc_ids, c_mask.shape[0], s, vd)
            valid = (gids >= 0) & hl[s]
            gids = torch.where(valid, gids, -1)
            docs, dmask = gather_candidates(c_embs, c_mask, cand.doc_ids)
            dmask = dmask & valid[:, :, None]
            n_cells = (valid.sum(dim=1) * T).to(torch.float32)
            if flavor == "dense":
                best, bg, st = _dense_scorecard(docs, dmask, q, gids, valid,
                                                k_shard)
                n_rev = n_cells
            else:
                kw = dict(knob)
                n_known = torch.zeros((B,), dtype=torch.float32, device=dev)
                if prereveal_ann:
                    pr = cand.known_mask & valid[:, :, None]
                    kw.update(prereveal=pr, prereveal_vals=cand.known_vals)
                    n_known = pr.sum(dim=(1, 2)).to(torch.float32)
                best, bg, cov, st = rerank(
                    docs, dmask, q, gids,
                    torch.where(valid[:, :, None], cand.a, 0.0),
                    torch.where(valid[:, :, None], cand.b, 0.0),
                    _shard_seeds(draws, base_seed, seed, s, B, dev), cfg,
                    draws=draws, **kw)
                # prereveal cells were free (stage 1 computed them)
                n_rev = torch.clamp(cov * n_cells - n_known, min=0.0)
            cards.append((best, bg))
            n_revs.append(n_rev)
            n_cellss.append(n_cells)
            # quarantine stays last, after the two routing-skew columns
            stats.append(torch.cat([st[:3], torch.stack([my_share.mean(),
                                                         my_share.max()]),
                                    st[3:]]))
        return _sharded_outputs(mesh, topk, cards, n_revs, n_cellss, stats)

    return step
