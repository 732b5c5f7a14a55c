"""Plain reference of what a served request returns: exhaustive MaxSim
over a candidate list, and stage-1 token kNN over the whole corpus.

Plain PyTorch only; it imports nothing of the program under test and
takes only the benchmark's own inputs (corpus, queries, candidate ids).
Float32 products run in full float32 (TF32 off) unless ``precision``
asks for the lower one, which is how the control of the correctness check
is made: ``"tf32"`` (float32 inputs, TF32 products) or ``"bf16"``
(inputs rounded to bfloat16).

    score(d, q) = sum_t max_{l valid in d} <q_t, d_l>
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Tuple

import torch

PRECISIONS = ("f32", "tf32", "bf16")


@contextlib.contextmanager
def precision(name: str) -> Iterator[torch.dtype]:
    """Products in ``name``'s precision; yields the input dtype."""
    if name not in PRECISIONS:
        raise ValueError(f"unknown precision {name!r}")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    tf32 = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield torch.bfloat16 if name == "bf16" else torch.float32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def candidate_scores(embs: torch.Tensor, mask: torch.Tensor,
                     queries: torch.Tensor, cand: torch.Tensor,
                     prec: str = "f32") -> torch.Tensor:
    """(B, T, M) queries, (B, N) candidate ids (-1 padding) -> (B, N)
    exhaustive MaxSim scores; padding scores -inf."""
    with precision(prec) as dt:
        safe = cand.clamp_min(0)
        docs = embs[safe].to(dt)                           # (B, N, L, M)
        sims = torch.einsum("btm,bnlm->bntl", queries.to(dt), docs).float()
        sims = sims.masked_fill(~mask[safe][:, :, None, :], float("-inf"))
        h = sims.amax(dim=-1)                              # (B, N, T)
        h = torch.where(torch.isfinite(h), h, 0.0)
        s = h.sum(dim=-1)
    return s.masked_fill(cand < 0, float("-inf"))


def exhaustive_topk(embs, mask, queries, cand, k: int, prec: str = "f32",
                    block: int = 8) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Top-``k`` of each query's candidates by exhaustive MaxSim, in
    blocks of ``block`` queries: (ids (B, k), scores (B, k), all scores
    (B, N))."""
    scores = torch.cat([candidate_scores(embs, mask, queries[i:i + block],
                                         cand[i:i + block], prec)
                        for i in range(0, queries.shape[0], block)])
    top, pos = torch.topk(scores, k, dim=1)
    ids = torch.where(torch.isfinite(top), torch.gather(cand, 1, pos), -1)
    return ids, top, scores


def knn_candidates(embs: torch.Tensor, mask: torch.Tensor,
                   query: torch.Tensor, kprime: int, n_max: int,
                   prec: str = "f32", chunk_docs: int = 16384
                   ) -> torch.Tensor:
    """Stage 1 of one (T, M) query: the k' nearest valid doc tokens of each
    query token over the whole corpus; the candidates are their documents,
    at most ``n_max`` of them, those with the highest best-hit similarity
    first. Returns the candidate ids, ascending."""
    C, L, M = embs.shape
    vals, idx = [], []
    with precision(prec) as dt:
        q = query.to(dt)
        for c0 in range(0, C, chunk_docs):
            c1 = min(C, c0 + chunk_docs)
            s = (q @ embs[c0:c1].reshape(-1, M).to(dt).T).float()
            s = s.masked_fill(~mask[c0:c1].reshape(1, -1), float("-inf"))
            v, i = torch.topk(s, min(kprime, s.shape[1]), dim=1)
            vals.append(v)
            idx.append(i + c0 * L)
    v, j = torch.topk(torch.cat(vals, 1), kprime, dim=1)      # (T, k')
    tok = torch.gather(torch.cat(idx, 1), 1, j)
    hit = (tok // L).reshape(-1)
    best = torch.full((C,), float("-inf"), device=embs.device)
    best = best.scatter_reduce(0, hit, v.reshape(-1), "amax")
    n_hit = int(torch.isfinite(best).sum())
    top = torch.topk(best, min(n_max, n_hit)).indices
    return torch.sort(top).values
