"""The plain reference against repro_torch's own plain versions (tests may
import both; the reference imports nothing of the program), and the check
against crafted answers."""
import pytest
import torch

from perfbench.data import corpus as data
from perfbench.reference import check
from perfbench.reference.maxsim import (candidate_scores, exhaustive_topk,
                                        knn_candidates)
from repro_torch.core.bandit import stable_topk
from repro_torch.kernels.maxsim import maxsim_batch_plain
from repro_torch.retrieval.ann import generate_candidates
from repro_torch.retrieval.service import gather_candidates

CFG = dict(n_docs=1024, doc_tokens=40, min_doc_tokens=8, query_tokens=16,
           dim=64, n_topics=4, relevant_per_query=4,
           distractors_per_query=24, topic_strength=0.7,
           distractor_strength=0.55)


@pytest.fixture(scope="module")
def made():
    g = data.generator(99, "cpu")
    c = data.make_corpus(CFG, g, "cpu")
    pool = data.make_queries(CFG, c, 8, g)
    return c, pool, data.make_candidates(c, pool, 48, g)


def test_exhaustive_topk_matches_plain_maxsim(made):
    c, pool, cand = made
    cand = cand.clone()
    cand[:, -3:] = -1                                  # padding
    ids, top, scores = exhaustive_topk(c.embs, c.mask, pool.queries, cand, 5)
    docs, dmask = gather_candidates(c.embs, c.mask, cand)
    h = maxsim_batch_plain(docs, dmask, pool.queries)
    h = torch.where(dmask.any(2)[:, :, None], h, 0.0)
    want = torch.where(cand >= 0, h.sum(-1), -3e38)
    assert torch.allclose(scores[cand >= 0], want[cand >= 0], atol=1e-5)
    wv, wi = stable_topk(want, 5)
    assert torch.equal(ids, torch.gather(cand, 1, wi))
    assert torch.allclose(top, wv, atol=1e-5)


def test_knn_candidates_match_plain_stage1(made):
    c, pool, _ = made
    for q in pool.queries[:4]:
        got = knn_candidates(c.embs, c.mask, q, kprime=10, n_max=48,
                             chunk_docs=300)
        cs = generate_candidates(c.embs, c.mask, q, kprime=10,
                                 max_candidates=48)
        want = cs.doc_ids[cs.doc_ids >= 0]
        assert torch.equal(got, want)


def test_lower_precision_moves_every_score(made):
    c, pool, cand = made
    f32 = candidate_scores(c.embs, c.mask, pool.queries, cand)
    bf16 = candidate_scores(c.embs, c.mask, pool.queries, cand, "bf16")
    gap = (f32 - bf16).abs()
    assert float(gap.median()) > 1e-4


def test_check_numbers(made):
    c, pool, cand = made
    ids, top, _ = exhaustive_topk(c.embs, c.mask, pool.queries, cand, 5)
    kw = dict(k=5, missing=0)
    good = check.numbers(c.embs, c.mask, pool.queries, cand, ids, top, **kw)
    assert good["bad_answers"] == 0 and good["overlap"] == 1.0
    assert good["score_gap_p50"] < 1e-5
    bad = ids.clone()
    bad[0, 1] = bad[0, 0]                              # a repeated doc
    bad[1, 0] = int(torch.isin(torch.arange(1024), cand[1],
                               invert=True).nonzero()[0])  # not a candidate
    n = check.numbers(c.embs, c.mask, pool.queries, cand, bad, top, **kw)
    assert n["bad_answers"] == 2 and n["overlap"] < 1
    shifted = torch.roll(ids, 1, dims=0)               # answers of others
    n = check.numbers(c.embs, c.mask, pool.queries, torch.roll(cand, 1, 0),
                      shifted, top, **kw)
    assert n["overlap"] < 0.5 and n["score_gap_p50"] > 1e-2
    lim = {"bad_answers": 0, "score_gap_p50": 1e-5}
    assert all(v["ok"] for v in check.judge(good, lim).values())
    assert not check.judge(n, lim)["score_gap_p50"]["ok"]


def test_stage1_check_uses_reference_candidates(made):
    c, pool, _ = made
    cands = check.reference_candidates(c.embs, c.mask, pool.queries, 10, 48)
    ids, top, _ = exhaustive_topk(c.embs, c.mask, pool.queries, cands, 5)
    n = check.numbers(c.embs, c.mask, pool.queries, None, ids, top, k=5,
                      missing=3, kprime=10, n_stage1=48)
    assert n["missing"] == 3 and n["stage1_miss"] == 0.0
    assert n["overlap"] == 1.0 and n["bad_answers"] == 0
