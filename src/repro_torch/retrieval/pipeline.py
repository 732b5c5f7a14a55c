"""Two-stage late-interaction retrieval pipeline (port of
``repro.retrieval.pipeline``).

Stage 1: per-token kNN candidate generation (+ Eq. 15 bounds).
Stage 2: dense or Col-Bandit rerank.

``serve_queries`` is the batched serving entry point over the service
steps. ``rerank_query`` / ``evaluate_dataset`` are the paper's research
harness: one query at a time over its candidate MaxSim matrix, with method
in {exact, bandit (Algorithm 1), batched (the block bandit), uniform
(Algorithm 2), topmargin (Algorithm 3)}. Cost follows the paper: the unit
is one MaxSim cell (Sec. 2.1); FLOPs weight each cell by its document's
true length (2 * M * L_i per cell).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import BanditConfig
from repro_torch.core import metrics as M
from repro_torch.core.bandit import run_bandit
from repro_torch.core.baselines import doc_top_margin, doc_uniform, \
    exact_topk
from repro_torch.core.batched import run_batched_oracle
from repro_torch.core.draws import TORCH_DRAWS, DrawSource
from repro_torch.kernels.ops import maxsim_op
from repro_torch.retrieval.ann import CandidateSet, generate_candidates, \
    generic_bounds
from repro_torch.retrieval.index import TokenIndex, build_index, \
    gather_tokens
from repro_torch.retrieval.service import (_require_dense,
                                           rerank_bandit_step,
                                           rerank_dense_step)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass
class RerankResult:
    topk_docs: np.ndarray        # (K,) global doc ids
    coverage: float              # Eq. 6
    flops: float                 # MaxSim FLOPs actually spent
    flops_exact: float           # FLOPs of full reranking
    overlap: float               # Eq. 16 vs exact rerank
    metrics: Dict[str, float]    # recall/mrr/ndcg vs qrels (if given)
    rounds: int = 0
    separated: bool = True


def _cell_flops(doc_lens: torch.Tensor, revealed: torch.Tensor,
                dim: int) -> torch.Tensor:
    """FLOPs = sum over revealed cells of 2*M*L_i."""
    per_doc = revealed.sum(dim=-1).to(torch.float32)          # cells per doc
    return (per_doc * doc_lens.to(torch.float32)).sum() * 2.0 * dim


def rerank_query(
    index: TokenIndex,
    query: torch.Tensor,              # (T, M)
    *,
    method: str = "bandit",
    k: int = 5,
    bandit: Optional[BanditConfig] = None,
    use_ann_bounds: bool = True,
    prereveal_ann: bool = False,      # beyond-paper: seed with stage-1 cells
    budget_fraction: float = 0.25,    # for the static baselines
    kprime: int = 10,
    max_candidates: int = 256,
    use_kernel: bool = False,         # ignored: JAX's lane choice
    qrels_row: Optional[np.ndarray] = None,
    seed: int = 0,
    draws: Optional[DrawSource] = None,
) -> RerankResult:
    """One query through stage 1 and a stage-2 ``method`` over its exact
    candidate MaxSim matrix H, which ``maxsim_op`` computes: the dense
    ``maxsim`` kernel on a card, the plain version on the CPU, whatever
    ``use_kernel`` says (JAX's choice between its kernel and its reference
    lane). Runs on the index's device; ``seed`` is the query's seed for
    ``draws`` (default ``TorchDraws``)."""
    draws = draws or TORCH_DRAWS
    bandit = bandit or BanditConfig(k=k)
    dev = index.doc_embs.device
    query = torch.as_tensor(query, dtype=torch.float32, device=dev)
    T = query.shape[0]
    cand = generate_candidates(index.doc_embs, index.doc_mask, query,
                               kprime=kprime, max_candidates=max_candidates,
                               support=bandit.support)
    embs, tok_mask = gather_tokens(index.doc_embs, index.doc_mask,
                                   cand.doc_ids)
    h_full = maxsim_op(embs, tok_mask, query)
    h_full = torch.where(cand.doc_mask[:, None], h_full, 0.0)

    if use_ann_bounds:
        a, b = cand.a, cand.b
    else:
        a, b = generic_bounds(*h_full.shape, support=bandit.support,
                              device=dev)
        a = torch.where(cand.doc_mask[:, None], a, 0.0)
        b = torch.where(cand.doc_mask[:, None], b, 0.0)

    exact_idx, _ = exact_topk(h_full, k=k, doc_mask=cand.doc_mask)
    doc_lens = index.doc_lens[torch.clamp(cand.doc_ids, min=0)]
    doc_lens = torch.where(cand.doc_mask, doc_lens, 0)
    dim = index.doc_embs.shape[2]
    flops_exact = float(_cell_flops(
        doc_lens, cand.doc_mask[:, None].expand(h_full.shape), dim))

    key = draws.key(seed, dev)
    rounds, separated = 0, True
    if method == "exact":
        topk_hat = exact_idx
        revealed = cand.doc_mask[:, None].expand(h_full.shape)
        coverage = 1.0
    elif method == "bandit":
        # Beyond-paper option: stage 1 already computed some cells exactly;
        # reveal them for free before the LUCB loop starts.
        res = run_bandit(
            h_full, a, b, key, k=k, delta=bandit.delta,
            alpha_ef=bandit.alpha_ef, epsilon=bandit.epsilon,
            radius_c=bandit.radius_c, bias_kappa=bandit.bias_kappa,
            warmup_fraction=bandit.warmup_fraction, doc_mask=cand.doc_mask,
            init_one_per_doc=not prereveal_ann,
            prereveal=cand.known_mask if prereveal_ann else None,
            draws=draws)
        topk_hat, revealed = res.topk, res.revealed
        if prereveal_ann:
            # stage-1 cells cost nothing; subtract them from the bill
            revealed = res.revealed & ~cand.known_mask
        coverage = float(res.coverage)
        rounds, separated = int(res.rounds), bool(res.separated)
    elif method == "batched":
        res = run_batched_oracle(
            h_full, a, b, key, k=k, delta=bandit.delta,
            alpha_ef=bandit.alpha_ef, epsilon=bandit.epsilon,
            radius_c=bandit.radius_c, bias_kappa=bandit.bias_kappa,
            block_docs=bandit.block_docs, block_tokens=bandit.block_tokens,
            doc_mask=cand.doc_mask, draws=draws)
        topk_hat, revealed = res.topk, res.revealed
        coverage = float(res.coverage)
        rounds, separated = int(res.rounds), bool(res.separated)
    elif method == "uniform":
        res = doc_uniform(h_full, key, k=k,
                          budget=max(1, int(budget_fraction * T)),
                          doc_mask=cand.doc_mask, draws=draws)
        topk_hat, revealed = res.topk, res.revealed
        coverage = float(res.coverage)
    elif method == "topmargin":
        res = doc_top_margin(h_full, a, b, k=k,
                             budget=max(1, int(budget_fraction * T)),
                             doc_mask=cand.doc_mask)
        topk_hat, revealed = res.topk, res.revealed
        coverage = float(res.coverage)
    else:
        raise ValueError(f"unknown method {method!r}")

    flops = float(_cell_flops(doc_lens, revealed, dim))
    overlap = float(M.overlap_at_k(topk_hat, exact_idx))
    topk_docs = cand.doc_ids[topk_hat].cpu().numpy()
    task_metrics: Dict[str, float] = {}
    if qrels_row is not None:
        rel = torch.as_tensor(np.asarray(qrels_row, bool), device=dev)
        rel_cand = torch.where(cand.doc_mask,
                               rel[torch.clamp(cand.doc_ids, min=0)], False)
        task_metrics = {
            "recall": float(M.recall_at_k(topk_hat, rel_cand)),
            "mrr": float(M.mrr_at_k(topk_hat, rel_cand)),
            "ndcg": float(M.ndcg_at_k(topk_hat, rel_cand)),
        }
    return RerankResult(topk_docs=topk_docs, coverage=coverage, flops=flops,
                        flops_exact=flops_exact, overlap=overlap,
                        metrics=task_metrics, rounds=rounds,
                        separated=separated)


def evaluate_dataset(dataset, *, method: str = "bandit", k: int = 5,
                     bandit: Optional[BanditConfig] = None, device="cuda",
                     index: Optional[TokenIndex] = None,
                     **kw) -> Dict[str, float]:
    """Mean coverage / overlap / FLOP saving / task metrics over the
    dataset's queries; query qi uses seed qi. ``index`` reuses an index of
    the dataset's corpus already on a device; otherwise one is built on
    ``device``."""
    if index is None:
        index = build_index(dataset.doc_embs, dataset.doc_mask,
                            dataset.doc_lens, device=_device(device))
    rows = [rerank_query(index, dataset.queries[qi], method=method, k=k,
                         bandit=bandit, qrels_row=dataset.qrels[qi], seed=qi,
                         **kw) for qi in range(dataset.n_queries)]
    out = {
        "coverage": float(np.mean([r.coverage for r in rows])),
        "coverage_std": float(np.std([r.coverage for r in rows])),
        "overlap": float(np.mean([r.overlap for r in rows])),
        "flops_saving": float(np.mean(
            [r.flops_exact / max(r.flops, 1.0) for r in rows])),
    }
    if rows and rows[0].metrics:
        for key in rows[0].metrics:
            out[key] = float(np.mean([r.metrics[key] for r in rows]))
    return out


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
    stage-1 candidates from a dense corpus). The queries' seeds are
    ``draws.keys(seed, B)`` (JAX: ``split(key(seed), B)``); ``draws``
    defaults to ``TorchDraws``."""
    draws = draws or TORCH_DRAWS
    dev = _device(device)
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
            draws.keys(seed, queries.shape[0], dev), topk=k,
            alpha_ef=bandit.alpha_ef, delta=bandit.delta,
            block_docs=bandit.block_docs, block_tokens=bandit.block_tokens,
            max_rounds=max_rounds, engine=engine, draws=draws)
    else:
        raise ValueError(f"unknown serving flavor {flavor!r}")
    return ServeResult(topk_scores=scores.cpu().numpy(),
                       topk_ids=gids.cpu().numpy(),
                       reveal_fraction=frac.cpu().numpy(),
                       stats=stats.cpu().numpy())
