"""Compressed-corpus serving, the port against the JAX package on the CPU.

For int8 and residual corpora (one seed each) the JAX side builds its
corpus with ``repro.retrieval.corpus.build_corpus`` and runs
``rerank_dense_step`` and ``rerank_bandit_step`` (``engine="pooled_fused"``
and ``"pooled_chain"``) in its plain lane (``REPRO_KERNEL_IMPL=ref``); the
port builds its own corpus and runs ``make_serving_step`` on it with
``JaxReplayDraws``. Stage 1 runs on each side's float32 corpus (the
compressed corpus cannot feed it). Result ids and reveal fractions must
match exactly; scores to rtol=1e-5 and stats to rtol=1e-6, since the
frameworks' float32 products sum in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import BanditConfig as JBanditConfig
from repro.data.synthetic import make_retrieval_dataset
from repro.retrieval.ann import generate_candidates as j_generate
from repro.retrieval.corpus import build_corpus as j_build_corpus
from repro.retrieval.service import rerank_bandit_step as j_bandit
from repro.retrieval.service import rerank_dense_step as j_dense
from repro_torch.configs.base import BanditConfig
from repro_torch.retrieval.corpus import build_corpus
from repro_torch.retrieval.index import from_numpy
from repro_torch.retrieval.pipeline import candidates_for, serve_queries
from repro_torch.retrieval.service import make_serving_step
from test_torch_core import JaxReplayDraws, key_data
from test_torch_threads import cap_torch_threads

cap_torch_threads()

K = 5
STAGE1 = dict(kprime=10, max_candidates=32)
CASES = {"int8": 0, "residual": 1}            # format -> dataset seed
CALLS = {"dense": ("dense", "pooled"),
         "fused": ("bandit", "pooled_fused"),
         "chain": ("bandit", "pooled_chain")}


def _dataset(seed):
    return make_retrieval_dataset(n_docs=64, n_queries=4, doc_len=24,
                                  min_doc_len=6, query_len=16, dim=32,
                                  seed=seed)


@pytest.fixture(scope="module")
def jax_steps():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_KERNEL_IMPL", "ref")
        for fmt, seed in CASES.items():
            ds = _dataset(seed)
            support = JBanditConfig(k=K).support
            cand = jax.vmap(lambda q: j_generate(
                jnp.asarray(ds.doc_embs), jnp.asarray(ds.doc_mask), q,
                support=support, **STAGE1))(jnp.asarray(ds.queries))
            corpus = j_build_corpus(ds.doc_embs, ds.doc_mask,
                                    corpus_format=fmt)
            args = (corpus.embs, corpus.mask, jnp.asarray(ds.queries),
                    cand.doc_ids, cand.a, cand.b, jax.random.key(seed))
            out[fmt, "dense"] = j_dense(*args, topk=K)
            for name in ("fused", "chain"):
                out[fmt, name] = j_bandit(*args, topk=K,
                                          engine=CALLS[name][1])
    return {k: tuple(np.asarray(x) for x in v) for k, v in out.items()}


def _port_step(fmt, name, engine=None):
    seed = CASES[fmt]
    ds = _dataset(seed)
    dense = from_numpy(ds.doc_embs, ds.doc_mask, ds.doc_lens, device="cpu")
    q = torch.from_numpy(ds.queries)
    cand = candidates_for(dense.doc_embs, dense.doc_mask, q,
                          support=BanditConfig(k=K).support, **STAGE1)
    corpus = build_corpus(ds.doc_embs, ds.doc_mask, corpus_format=fmt,
                          device="cpu")
    flavor, default_engine = CALLS[name]
    step = make_serving_step(flavor, topk=K, engine=engine or default_engine,
                             draws=JaxReplayDraws())
    seeds = key_data(jax.random.split(jax.random.key(seed), q.shape[0]))
    out = step(corpus.embs, corpus.mask, q, cand.doc_ids, cand.a, cand.b,
               seeds)
    return tuple(x.numpy() for x in out)


@pytest.mark.parametrize("name", list(CALLS))
@pytest.mark.parametrize("fmt", list(CASES))
def test_compressed_serving_matches_jax(jax_steps, fmt, name):
    want = jax_steps[fmt, name]
    scores, ids, frac, stats = _port_step(fmt, name)
    np.testing.assert_array_equal(ids, want[1])
    np.testing.assert_array_equal(frac, want[2])
    np.testing.assert_allclose(scores, want[0], rtol=1e-5)
    np.testing.assert_allclose(stats, want[3], rtol=1e-6)
    if name != "dense":
        assert frac.mean() < 1.0


@pytest.mark.parametrize("fmt", list(CASES))
def test_compressed_pooled_is_the_fused_body(fmt):
    got = _port_step(fmt, "fused", engine="pooled")
    want = _port_step(fmt, "fused")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_serve_queries_refuses_a_quantized_corpus():
    ds = _dataset(3)
    corpus = build_corpus(ds.doc_embs, ds.doc_mask, corpus_format="int8",
                          device="cpu")
    with pytest.raises(ValueError, match="'int8'-quantized"):
        serve_queries(corpus, ds.queries, device="cpu")


@pytest.mark.parametrize("flavor", ["dense", "bandit"])
def test_serve_queries_on_a_corpus_equals_on_an_index(flavor):
    ds = _dataset(4)
    corpus = build_corpus(ds.doc_embs, ds.doc_mask, device="cpu")
    index = from_numpy(ds.doc_embs, ds.doc_mask, ds.doc_lens, device="cpu")
    kw = dict(k=K, flavor=flavor, seed=4, device="cpu", **STAGE1)
    got = serve_queries(corpus, ds.queries, **kw)
    want = serve_queries(index, ds.queries, **kw)
    for field in ("topk_ids", "topk_scores", "reveal_fraction", "stats"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
