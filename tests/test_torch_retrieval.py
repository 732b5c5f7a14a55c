"""Stage 1 and the whole serving slice of the port against the JAX package,
on the CPU.

The JAX side runs its plain lane (``REPRO_KERNEL_IMPL=ref``); its fused
round body is ``engine="pooled_fused"`` there, since ``"pooled"`` resolves
to the chain body under ``ref``. The port replays JAX's key chain through
``JaxReplayDraws``. Result ids and reveal fractions must match exactly;
scores and stage-1 bounds to rtol=1e-5, because the frameworks' float32
matrix products sum in different orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import colbert_repro as jcolbert
from repro.configs.base import BanditConfig as JBanditConfig
from repro.core.metrics import overlap_at_k as j_overlap
from repro.data.synthetic import make_retrieval_dataset
from repro.retrieval.ann import generate_candidates as j_generate
from repro.retrieval.ann import generic_bounds as j_generic_bounds
from repro.retrieval.corpus import gather_tokens as j_gather_tokens
from repro.retrieval.index import build_index as j_build_index
from repro.retrieval.pipeline import serve_queries as j_serve
from repro_torch.configs import colbert_repro as tcolbert
from repro_torch.configs.base import BanditConfig
from repro_torch.core.draws import TorchDraws
from repro_torch.core.frontier import init_frontier_state
from repro_torch.core.metrics import overlap_at_k
from repro_torch.retrieval.ann import generate_candidates, generic_bounds
from repro_torch.retrieval.index import from_arrays, from_numpy, \
    gather_tokens
from repro_torch.retrieval.pipeline import candidates_for, serve_queries
from repro_torch.retrieval.service import init_stream_state, \
    make_serving_step, rerank_bandit_step, rerank_dense_step
from repro_torch.serve import (AsyncRetrievalEngine, EngineConfig,
                               RetrievalEngine)
from test_torch_core import JaxReplayDraws, key_data
from test_torch_threads import cap_torch_threads

cap_torch_threads()

RTOL, ATOL = 1e-5, 1e-6


def _dataset(seed, **kw):
    args = dict(n_docs=64, n_queries=4, doc_len=24, min_doc_len=6,
                query_len=16, dim=32, seed=seed)
    args.update(kw)
    return make_retrieval_dataset(**args)


# ---------------------------------------------------------------------------
# (f) stage 1
# ---------------------------------------------------------------------------

STAGE1 = {    # (dataset overrides, generate_candidates arguments)
    "union": (dict(n_docs=48, doc_len=16),
              dict(kprime=10, max_candidates=32)),
    "truncated": (dict(n_docs=48, doc_len=16),
                  dict(kprime=10, max_candidates=8)),
    "kprime-clamp": (dict(n_docs=2, doc_len=3, relevant_per_query=1),
                     dict(kprime=10, max_candidates=4)),
}


@pytest.mark.parametrize("case", list(STAGE1))
def test_generate_candidates_matches_jax(case):
    data, kw = STAGE1[case]
    ds = _dataset(5, min_doc_len=2, query_len=8, dim=16, **data)
    for q in ds.queries:
        want = j_generate(jnp.asarray(ds.doc_embs), jnp.asarray(ds.doc_mask),
                          jnp.asarray(q), **kw)
        got = generate_candidates(torch.from_numpy(ds.doc_embs),
                                  torch.from_numpy(ds.doc_mask),
                                  torch.from_numpy(q), **kw)
        for field in ("doc_ids", "doc_mask", "known_mask"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)),
                                          err_msg=field)
        for field in ("a", "b", "known_vals", "s_kprime"):
            np.testing.assert_allclose(getattr(got, field).numpy(),
                                       np.asarray(getattr(want, field)),
                                       rtol=RTOL, atol=ATOL, err_msg=field)


def test_generic_bounds_match_jax():
    want = j_generic_bounds(5, 7, support=(0.1, 0.9))
    got = generic_bounds(5, 7, support=(0.1, 0.9), device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_index_carries_a_jax_index_and_gathers_padding_masked():
    ds = _dataset(6, n_docs=20, doc_len=8)
    jidx = j_build_index(ds.doc_embs, ds.doc_mask, ds.doc_lens)
    tidx = from_arrays(jidx, device="cpu")
    np.testing.assert_array_equal(tidx.doc_embs.numpy(), ds.doc_embs)
    ids = np.array([[3, -1, 7], [-1, -1, 0]])
    want_e, want_m = j_gather_tokens(jidx.doc_embs, jidx.doc_mask,
                                     jnp.asarray(ids))
    got_e, got_m = gather_tokens(tidx.doc_embs, tidx.doc_mask,
                                 torch.from_numpy(ids))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert not got_m[0, 1].any() and not got_m[1, :2].any()


def test_configs_carry_across():
    jcfg = JBanditConfig(k=7, alpha_ef=0.5, block_docs=16)
    assert BanditConfig(**dataclasses.asdict(jcfg)) == BanditConfig(
        k=7, alpha_ef=0.5, block_docs=16)
    assert dataclasses.asdict(BanditConfig()) == dataclasses.asdict(
        JBanditConfig())
    for name in ("TEXT_CONFIG", "MM_CONFIG"):
        j, t = getattr(jcolbert, name), getattr(tcolbert, name)
        for f in ("name", "query_tokens", "doc_tokens", "dim", "corpus_docs",
                  "ann_kprime"):
            assert getattr(t, f) == getattr(j, f), (name, f)


def test_overlap_at_k_matches_jax():
    a = np.array([[1, 2, 3, 4, 5], [9, 8, 7, 6, 5]])
    b = np.array([[5, 4, 3, 2, 1], [1, 2, 3, 5, 6]])
    got = overlap_at_k(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = [float(j_overlap(jnp.asarray(x), jnp.asarray(y)))
            for x, y in zip(a, b)]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# (g) the whole slice: serve_queries dense and bandit, both round bodies
# ---------------------------------------------------------------------------

SEEDS = (0, 1)
CALLS = {"dense": dict(flavor="dense", engine="pooled"),
         "fused": dict(flavor="bandit", engine="pooled_fused"),
         "chain": dict(flavor="bandit", engine="pooled_chain")}
SERVE = dict(k=5, max_candidates=32, kprime=10)


@pytest.fixture(scope="module")
def jax_serving():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_KERNEL_IMPL", "ref")
        for seed in SEEDS:
            ds = _dataset(seed)
            jidx = j_build_index(ds.doc_embs, ds.doc_mask, ds.doc_lens)
            for name, kw in CALLS.items():
                out[seed, name] = j_serve(jidx, ds.queries, seed=seed,
                                          bandit=JBanditConfig(k=5),
                                          **SERVE, **kw)
    return out


def _port_serve(seed, name, engine=None):
    ds = _dataset(seed)
    idx = from_numpy(ds.doc_embs, ds.doc_mask, ds.doc_lens, device="cpu")
    kw = dict(CALLS[name])
    if engine:
        kw["engine"] = engine
    return serve_queries(idx, ds.queries, seed=seed, device="cpu",
                         bandit=BanditConfig(k=5), draws=JaxReplayDraws(),
                         **SERVE, **kw)


@pytest.mark.parametrize("name", list(CALLS))
@pytest.mark.parametrize("seed", SEEDS)
def test_serve_queries_matches_jax(jax_serving, seed, name):
    want = jax_serving[seed, name]
    got = _port_serve(seed, name)
    np.testing.assert_array_equal(got.topk_ids, want.topk_ids)
    np.testing.assert_array_equal(got.reveal_fraction, want.reveal_fraction)
    np.testing.assert_allclose(got.topk_scores, want.topk_scores, rtol=RTOL)
    np.testing.assert_allclose(got.stats, want.stats, rtol=1e-6)
    if name != "dense":
        assert got.reveal_fraction.mean() < 1.0


def test_serve_queries_pooled_is_the_fused_body():
    got = _port_serve(0, "fused", engine="pooled")
    want = _port_serve(0, "fused")
    for field in ("topk_ids", "topk_scores", "reveal_fraction", "stats"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


def test_make_serving_step_is_the_rerank_steps():
    ds = _dataset(2)
    idx = from_numpy(ds.doc_embs, ds.doc_mask, ds.doc_lens, device="cpu")
    q = torch.from_numpy(ds.queries)
    cand = candidates_for(idx.doc_embs, idx.doc_mask, q, kprime=10,
                          max_candidates=32, support=(0.0, 1.0))
    args = (idx.doc_embs, idx.doc_mask, q, cand.doc_ids, cand.a, cand.b)
    seeds = key_data(jax.random.split(jax.random.key(2), q.shape[0]))
    got = make_serving_step("bandit", topk=5, engine="pooled_chain",
                            draws=JaxReplayDraws())(*args, seeds)
    want = rerank_bandit_step(*args, seeds, draws=JaxReplayDraws(), topk=5,
                              engine="pooled_chain")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(make_serving_step("dense", topk=5)(*args),
                    rerank_dense_step(*args, topk=5)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="unknown serving flavor"):
        make_serving_step("sparse")
    with pytest.raises(ValueError, match="unknown reveal engine"):
        make_serving_step("bandit", engine="lockstep")


def test_entry_points_default_to_cuda_and_never_fall_back():
    ds = _dataset(0, n_docs=8, doc_len=4, min_doc_len=2)
    idx = from_numpy(ds.doc_embs, ds.doc_mask, ds.doc_lens, device="cpu")
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="build it with"):
            serve_queries(idx, ds.queries)
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            serve_queries(idx, ds.queries)
        with pytest.raises((RuntimeError, AssertionError)):
            from_numpy(ds.doc_embs, ds.doc_mask, ds.doc_lens)
    # Seeds, empty stream states and the serving engines' corpora are made
    # on the card by default.
    cfg = EngineConfig(batch_size=2, token_buckets=(4,), cand_buckets=(4,))
    for make in (lambda: TorchDraws().key(0), lambda: TorchDraws().keys(0, 2),
                 lambda: init_frontier_state(2, 4, 3).draw,
                 lambda: init_stream_state(2, 4, 3).rounds,
                 lambda: RetrievalEngine(ds.doc_embs, ds.doc_mask,
                                         cfg).corpus_embs,
                 lambda: AsyncRetrievalEngine(ds.doc_embs, ds.doc_mask,
                                              cfg).corpus_embs):
        if torch.cuda.is_available():
            assert make().is_cuda
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                make()
    with pytest.raises(ValueError, match="unknown serving flavor"):
        serve_queries(idx, ds.queries, flavor="sparse", device="cpu")
    with pytest.raises(ValueError, match="unknown reveal engine"):
        serve_queries(idx, ds.queries, engine="lockstep", device="cpu")
