"""The comparison that decides ``correct``.

Each served answer is judged by what it says, against the plain reference
(``reference.maxsim``) on the benchmark's own inputs:

* ``missing``: requests sent in the window that got no answer, or an
  error answer, within a minute of its close;
* ``bad_answers``: answers that are not ``k`` distinct documents of the
  request's candidate list (for requests without one: of the corpus);
* ``overlap_deficit``: 1 - mean overlap@k of the answers with the
  exhaustive-MaxSim top-k over the same candidates (for requests without
  a list: over the reference's own stage-1 candidates). The bandit stops
  at its confidence level, so sound runs read a steady deficit of their
  own; the exact dense path reads 0 but for ties;
* ``score_gap_p50``: the median, over every returned document, of |its
  returned score - its exhaustive MaxSim score|. A document the bandit
  revealed in full carries its exact score, so the median sits at float32
  rounding, while any lower precision moves every score;
* ``score_off_share``: the share of returned documents whose score is
  more than ``OFF`` from its exhaustive MaxSim score. The bandit certifies
  some documents into the top-k before revealing them in full, so a few
  in a hundred carry an estimate, and the largest gap is no limit; a fault
  that moves the scores of one answer in four moves this share by a
  quarter, where the median does not move;
* ``stage1_miss`` (requests without a list): the share of returned
  documents outside the reference's stage-1 candidates.

A number passes when it is at most its limit, which the cell's own file
states: ``missing`` and ``bad_answers`` exactly 0, the others set between
the program's readings over many seeds and those of the control or of the
faults each number is there to catch.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from perfbench.reference.maxsim import (candidate_scores,
                                        exhaustive_topk, knn_candidates)

# A returned score further than this from exhaustive MaxSim is an estimate
# or a fault: float32 rounding stays under 2e-6, TF32 moves scores by 1e-4.
OFF = 3e-05


def reference_candidates(embs, mask, queries, kprime: int, n_max: int,
                         prec: str = "f32") -> torch.Tensor:
    """(S, n_max) stage-1 candidates of each query, -1 padded."""
    out = torch.full((queries.shape[0], n_max), -1, dtype=torch.long,
                     device=embs.device)
    for s in range(queries.shape[0]):
        c = knn_candidates(embs, mask, queries[s], kprime, n_max, prec)
        out[s, :c.numel()] = c
    return out


def numbers(embs, mask, queries: torch.Tensor, cands: Optional[torch.Tensor],
            ids: torch.Tensor, scores: torch.Tensor, *, k: int,
            missing: int, kprime: int = 0, n_stage1: int = 0,
            prec: str = "f32") -> Dict[str, float]:
    """The check's numbers for S answered requests: ``queries`` (S, T, M),
    ``cands`` (S, N) with -1 padding or None (stage-1 requests), ``ids``
    and ``scores`` (S, k) as answered. Also ``overlap``, the mean
    overlap@k."""
    S = ids.shape[0]
    out: Dict[str, float] = {"missing": float(missing)}
    if S == 0:
        return dict(out, bad_answers=0.0, overlap_deficit=1.0,
                    score_gap_p50=float("inf"), score_off_share=1.0,
                    stage1_miss=1.0, overlap=0.0)
    ids = ids.to(torch.long)
    C = embs.shape[0]
    distinct = (ids[:, :, None] == ids[:, None, :]).sum((1, 2)) == k
    valid = ((ids >= 0) & (ids < C)).all(1)
    stage1 = cands is None
    if stage1:
        cands = reference_candidates(embs, mask, queries, kprime, n_stage1)
        in_list = torch.ones_like(valid)
        miss = ~(ids[:, :, None] == cands[:, None, :]).any(-1)
        out["stage1_miss"] = float(miss.float().mean())
    else:
        in_list = (ids[:, :, None] == cands[:, None, :]).any(-1).all(1)
    out["bad_answers"] = float((~(distinct & valid & in_list)).sum())
    ref_ids, _, _ = exhaustive_topk(embs, mask, queries, cands, k, prec)
    overlap = (ids[:, :, None] == ref_ids[:, None, :]).any(-1).float()
    out["overlap"] = float(overlap.mean())
    out["overlap_deficit"] = 1.0 - out["overlap"]
    safe = torch.where((ids >= 0) & (ids < C), ids, 0)
    exact = torch.cat([candidate_scores(embs, mask, queries[i:i + 8],
                                        safe[i:i + 8], prec)
                       for i in range(0, S, 8)])
    gap = (scores.to(exact.device).float() - exact).abs()
    gap = torch.where(torch.isfinite(gap), gap, torch.full_like(gap, 1e30))
    out["score_gap_p50"] = float(gap.median())
    out["score_off_share"] = float((gap > OFF).float().mean())
    return out


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each limited number beside its limit, and whether it passed."""
    return {name: {"value": nums[name], "limit": lim,
                   "ok": bool(nums[name] <= lim)}
            for name, lim in limits.items()}
