"""The device generator keeps the statistics of the NumPy generator it was
rewritten from (``repro_torch.data.synthetic.make_retrieval_dataset``),
and the same seed gives the same inputs."""
import numpy as np
import pytest
import torch

from perfbench.data import corpus as data
from perfbench.reference.maxsim import candidate_scores
from repro_torch.data.synthetic import make_retrieval_dataset

CFG = dict(n_docs=2048, doc_tokens=48, min_doc_tokens=16, query_tokens=32,
           dim=128, n_topics=8, relevant_per_query=4,
           distractors_per_query=24, topic_strength=0.7,
           distractor_strength=0.55)
P = 32


def _made(seed):
    g = data.generator(seed, "cpu")
    c = data.make_corpus(CFG, g, "cpu")
    pool = data.make_queries(CFG, c, P, g)
    return c, pool, data.make_candidates(c, pool, 64, g)


def _mean_scores(embs, mask, queries, rel, dis, rand):
    out = []
    for ids in (rel, dis, rand):
        s = candidate_scores(embs, mask, queries, ids)
        out.append(float(s.mean()))
    return out


def test_same_seed_same_inputs():
    a, b = _made(7), _made(7)
    assert torch.equal(a[0].embs, b[0].embs)
    assert torch.equal(a[1].queries, b[1].queries)
    assert torch.equal(a[2], b[2])
    assert not torch.equal(a[0].embs, _made(8)[0].embs)


def test_tokens_lengths_and_candidates():
    c, pool, cand = _made(2 ** 31 + 5)
    norms = c.embs.norm(dim=-1)
    assert torch.allclose(norms[c.mask], torch.ones(()), atol=1e-5)
    assert float(norms[~c.mask].abs().max()) == 0.0
    assert int(c.doc_lens.min()) >= 16 and int(c.doc_lens.max()) <= 48
    assert torch.equal(c.mask.sum(1), c.doc_lens)
    for p in range(P):
        ids = cand[p]
        assert ids.unique().numel() == 64
        planted = set(torch.cat([pool.relevant[p],
                                 pool.distractors[p]]).tolist())
        assert planted <= set(ids.tolist())
        rest = [i for i in ids.tolist() if i not in planted]
        assert (c.doc_topic[rest] == pool.topic[p]).all()
    planted = torch.cat([pool.relevant, pool.distractors], 1).reshape(-1)
    assert planted.unique().numel() == planted.numel()


def test_statistics_match_numpy_generator():
    c, pool, _ = _made(11)
    rng = np.random.default_rng(0)
    rand = torch.as_tensor(rng.integers(0, CFG["n_docs"], (P, 24)))
    mine = _mean_scores(c.embs, c.mask, pool.queries, pool.relevant,
                        pool.distractors, rand)
    ds = make_retrieval_dataset(n_docs=2048, n_queries=P, n_topics=8,
                                doc_len=48, min_doc_len=16, query_len=32,
                                dim=128, seed=3)
    rel = torch.as_tensor(np.stack([np.flatnonzero(r)[:4] for r in ds.qrels]))
    # the NumPy generator plants distractors without recording them: its
    # statistics are read from the queries' own-topic docs instead
    embs = torch.as_tensor(ds.doc_embs)
    mask = torch.as_tensor(ds.doc_mask)
    ref = candidate_scores(embs, mask, torch.as_tensor(ds.queries), rel)
    ref_rand = candidate_scores(embs, mask, torch.as_tensor(ds.queries), rand)
    # relevant docs score far above random ones, at the same scale
    assert mine[0] > mine[1] > mine[2]
    assert mine[0] == pytest.approx(float(ref.mean()), rel=0.15)
    assert mine[2] == pytest.approx(float(ref_rand.mean()), rel=0.15)
    # the per-query spread of relevant scores is alike too
    s_mine = candidate_scores(c.embs, c.mask, pool.queries, pool.relevant)
    assert float(s_mine.std()) == pytest.approx(float(ref.std()), rel=0.5)
