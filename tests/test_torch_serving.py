"""The port's serving steps against the JAX package, on the CPU: the
continuous-batching step (``init_stream_state`` / ``make_streaming_step``)
on a float32 and an int8 corpus, the knob-taking dense and bandit steps,
the lockstep engine (``engine="vmapped"``), shape buckets and the
``DegradeLadder``.

The JAX side runs its plain lane (``REPRO_KERNEL_IMPL=ref``); both sides
rerank the same stage-1 candidates (JAX's, as numpy), and the port replays
JAX's keys per query (``JaxReplayDraws``). Ids, reveal fractions, harvest
flags, rounds and draw states must match exactly; scores and stats to
rtol=1e-5. The lockstep engine's cells come from a gathered einsum in both
frameworks, which sum each cell in their own float order; on these inputs
no decision flips, and scores match to rtol=1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import BanditConfig as JBanditConfig
from repro.data.synthetic import make_retrieval_dataset
from repro.retrieval.ann import generate_candidates as j_generate
from repro.retrieval.corpus import build_corpus as j_build_corpus
from repro.retrieval import service as jservice
from repro.serve import bucketing as jbucketing
from repro.serve.resilience import DegradeLadder as JLadder
from repro_torch.core.draws import TorchDraws
from repro_torch.core.frontier import _REV_THRESH
from repro_torch.retrieval import service
from repro_torch.retrieval.corpus import build_corpus
from repro_torch.serve import bucketing
from repro_torch.serve.resilience import DegradeLadder
from test_torch_core import JaxReplayDraws, key_data
from test_torch_threads import cap_torch_threads

cap_torch_threads()

K = 5
REPLAY = JaxReplayDraws()
RTOL = 1e-5
STEP_KW = dict(topk=K, block_docs=8, block_tokens=4)


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _inputs(seed, n_queries=6):
    """Dataset and JAX's stage-1 candidates as numpy."""
    ds = make_retrieval_dataset(n_docs=64, n_queries=n_queries, doc_len=24,
                                min_doc_len=6, query_len=16, dim=32,
                                seed=seed)
    support = JBanditConfig(k=K).support
    cand = jax.vmap(lambda q: j_generate(
        jnp.asarray(ds.doc_embs), jnp.asarray(ds.doc_mask), q,
        kprime=10, max_candidates=32, support=support))(
            jnp.asarray(ds.queries))
    return ds, tuple(np.asarray(x) for x in (cand.doc_ids, cand.a, cand.b))


def _corpora(ds, fmt):
    return (j_build_corpus(ds.doc_embs, ds.doc_mask, corpus_format=fmt),
            build_corpus(ds.doc_embs, ds.doc_mask, corpus_format=fmt,
                         device="cpu"))


@pytest.fixture
def ref_lane(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "ref")


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------

def _stream(step, state, rows, seeds, n_slots, to_side):
    """Drive a streaming step over the queries of ``rows`` (queries,
    cand_ids, a, b numpy arrays indexed by query) through ``n_slots``
    slots; a harvested slot takes the next query. Returns every call's
    outputs (numpy) and {query: (ids, frac)} at harvest."""
    queue = list(range(len(rows[0])))
    slot_q = [queue.pop(0) for _ in range(n_slots)]
    fresh = np.ones(n_slots, bool)
    calls, harvested = [], {}
    for _ in range(200):
        idx = np.asarray(slot_q)
        out = step(*(to_side(r[idx]) for r in rows), state,
                   to_side(fresh), seeds(idx))
        *outs, harvest, state = out
        outs = [np.asarray(x) for x in (*outs, harvest)]
        calls.append((outs, state))
        fresh[:] = False
        for s in range(n_slots):
            q = slot_q[s]
            if outs[4][s] and q not in harvested:
                harvested[q] = (outs[1][s], outs[2][s])
                if queue:
                    slot_q[s] = queue.pop(0)
                    fresh[s] = True
        if len(harvested) == len(rows[0]):
            return calls, harvested
    pytest.fail("stream never drained")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "chain"])
@pytest.mark.parametrize("fmt", ["bf16", "int8"], ids=["f32", "int8"])
def test_streaming_step_matches_jax(ref_lane, fmt, fused):
    ds, (cand, a, b) = _inputs(11)
    j_corpus, t_corpus = _corpora(ds, fmt)
    keys = jax.random.split(jax.random.key(11), ds.n_queries)
    rows = (ds.queries, cand, a, b)
    S, N, T = 3, cand.shape[1], ds.queries.shape[1]

    j_step = jax.jit(functools.partial(
        jservice.make_streaming_step(trip_limit=2, fused=fused, **STEP_KW),
        j_corpus.embs, j_corpus.mask))
    want, want_h = _stream(j_step, jservice.init_stream_state(S, N, T),
                           rows, lambda i: keys[i], S, jnp.asarray)
    t_step = functools.partial(
        service.make_streaming_step(trip_limit=2, fused=fused,
                                    draws=REPLAY, **STEP_KW),
        t_corpus.embs, t_corpus.mask)
    got, got_h = _stream(t_step,
                         service.init_stream_state(S, N, T, device="cpu"),
                         rows, lambda i: key_data(keys[i]), S, _t)
    assert len(got) == len(want)
    for (g, g_state), (w, w_state) in zip(got, want):
        for i in (1, 2, 4):                      # ids, frac, harvest
            np.testing.assert_array_equal(g[i], w[i])
        np.testing.assert_allclose(g[0], w[0], rtol=RTOL)
        np.testing.assert_allclose(g[3], w[3], rtol=RTOL)
        np.testing.assert_array_equal(g_state.rounds, w_state.rounds)
        np.testing.assert_array_equal(g_state.done, w_state.done)
        np.testing.assert_array_equal(g_state.draw, key_data(w_state.key))
        np.testing.assert_array_equal(
            g_state.cellvals < _REV_THRESH,
            np.asarray(w_state.cellvals) < _REV_THRESH)
    assert got_h.keys() == want_h.keys()

    # Every streamed query equals the one-shot batch step on its (query,
    # seed): the stream's slotmates and admission trip do not matter.
    one = service.rerank_bandit_step(
        t_corpus.embs, t_corpus.mask, _t(ds.queries), _t(cand), _t(a),
        _t(b), key_data(keys), draws=REPLAY,
        engine="pooled" if fused else "pooled_chain", **STEP_KW)
    for q, (ids, frac) in got_h.items():
        np.testing.assert_array_equal(ids, one[1][q].numpy())
        assert frac == float(one[2][q])


def test_streaming_step_harvests_round_capped_slots():
    ds, (cand, a, b) = _inputs(12, n_queries=2)
    corpus = build_corpus(ds.doc_embs, ds.doc_mask, device="cpu")
    step = service.make_streaming_step(trip_limit=1, max_rounds=2,
                                       **STEP_KW)
    state = service.init_stream_state(2, cand.shape[1], 16, device="cpu")
    fresh = torch.ones(2, dtype=torch.bool)
    seeds = TorchDraws().keys(0, 2, "cpu")
    for _ in range(2):
        *_, harvest, state = step(corpus.embs, corpus.mask,
                                  _t(ds.queries), _t(cand), _t(a), _t(b),
                                  state, fresh, seeds)
        fresh = torch.zeros(2, dtype=torch.bool)
    assert bool(harvest.all()) and int(state.rounds.max()) == 2
    with pytest.raises(ValueError, match="trip_limit"):
        service.make_streaming_step(trip_limit=0)


# ---------------------------------------------------------------------------
# batch steps: fidelity knobs and the lockstep engine
# ---------------------------------------------------------------------------

def _batch_args(seed, fmt="bf16"):
    ds, (cand, a, b) = _inputs(seed)
    j_corpus, t_corpus = _corpora(ds, fmt)
    j_args = (j_corpus.embs, j_corpus.mask, jnp.asarray(ds.queries),
              jnp.asarray(cand), jnp.asarray(a), jnp.asarray(b))
    t_args = (t_corpus.embs, t_corpus.mask, _t(ds.queries), _t(cand),
              _t(a), _t(b))
    key = jax.random.key(seed)
    return j_args, t_args, key, key_data(jax.random.split(
        key, ds.n_queries))


def _assert_step_equal(got, want):
    got = [x.numpy() for x in got]
    want = [np.asarray(x) for x in want]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
    np.testing.assert_allclose(got[3], want[3], rtol=RTOL)


LEVELS = list(range(DegradeLadder().n_levels))


@pytest.mark.parametrize("engine", ["pooled_fused", "pooled_chain"])
@pytest.mark.parametrize("level", LEVELS)
def test_bandit_step_knobs_match_jax(ref_lane, level, engine):
    j_args, t_args, key, seeds = _batch_args(13)
    alpha, cap = DegradeLadder().knobs(level)
    want = jservice.rerank_bandit_step(
        *j_args, key, engine=engine, alpha_scale=jnp.float32(alpha),
        round_cap=jnp.int32(cap), **STEP_KW)
    step = service.make_serving_step("bandit", engine=engine, draws=REPLAY,
                                     **STEP_KW)
    got = step(*t_args, seeds, alpha_scale=torch.tensor(alpha),
               round_cap=torch.tensor(cap))
    _assert_step_equal(got, want)
    if level == 0:
        for g, w in zip(got, step(*t_args, seeds)):
            assert torch.equal(g, w)


def test_dense_step_accepts_and_ignores_knobs():
    _, t_args, _, seeds = _batch_args(14)
    dense = service.make_serving_step("dense", **STEP_KW)
    for g, w in zip(dense(*t_args, seeds, alpha_scale=8.0, round_cap=4),
                    dense(*t_args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("seed", [15, 16])
def test_vmapped_engine_matches_jax(ref_lane, seed):
    j_args, t_args, key, seeds = _batch_args(seed)
    want = jservice.rerank_bandit_step(*j_args, key, engine="vmapped",
                                       **STEP_KW)
    got = service.make_serving_step("bandit", engine="vmapped",
                                    draws=REPLAY, **STEP_KW)(
        *t_args, seeds, alpha_scale=4.0, round_cap=2)   # knobs ignored
    _assert_step_equal(got, want)
    waste = got[3][2]
    assert waste >= 0 and float(got[3][1]) > 0


def test_vmapped_engine_refuses_a_quantized_corpus():
    _, t_args, _, seeds = _batch_args(17, fmt="int8")
    with pytest.raises(ValueError, match="vmapped lockstep engine"):
        service.rerank_bandit_step(*t_args, seeds, engine="vmapped",
                                   **STEP_KW)


# ---------------------------------------------------------------------------
# shape buckets and the fidelity ladder
# ---------------------------------------------------------------------------

def test_shape_buckets_match_jax():
    kw = dict(token_buckets=(32, 8, 16, 16), cand_buckets=(64, 256))
    got, want = bucketing.ShapeBuckets(**kw), jbucketing.ShapeBuckets(**kw)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.all_buckets() == want.all_buckets()
    for n in (1, 8, 9, 17, 32):
        assert got.token_bucket(n) == want.token_bucket(n)
    for n in (1, 64, 65, 256):
        assert got.cand_bucket(n) == want.cand_bucket(n)
    for mod in (bucketing, jbucketing):
        with pytest.raises(ValueError, match="exceeds the largest bucket"):
            mod.ShapeBuckets(**kw).token_bucket(33)
        with pytest.raises(ValueError, match="non-empty and positive"):
            mod.ShapeBuckets(token_buckets=(), cand_buckets=(4,))


def test_padding_helpers_match_jax():
    rng = np.random.default_rng(18)
    queries = [rng.standard_normal((t, 8)).astype(np.float32)
               for t in (3, 7, 5)]
    cands = [rng.integers(0, 99, n) for n in (4, 9)] + [None]
    np.testing.assert_array_equal(bucketing.pad_queries(queries, 8),
                                  jbucketing.pad_queries(queries, 8))
    pc = bucketing.pad_candidates(cands, 12)
    np.testing.assert_array_equal(pc, jbucketing.pad_candidates(cands, 12))
    for got, want in zip(
            bucketing.support_bounds(pc, [3, 7, 5], 8, (0.0, 1.0)),
            jbucketing.support_bounds(pc, [3, 7, 5], 8, (0.0, 1.0))):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="bucket"):
        bucketing.pad_queries(queries, 4)
    with pytest.raises(ValueError, match="bucket"):
        bucketing.pad_candidates(cands, 5)


@pytest.mark.parametrize("kw", [
    {}, dict(headrooms=(2.0, 0.3), alpha_scales=(1.5, 3.0),
             round_caps=(16, 2))])
def test_degrade_ladder_matches_jax(kw):
    got, want = DegradeLadder(**kw), JLadder(**kw)
    assert got.n_levels == want.n_levels
    for r in np.linspace(-0.5, 2.5, 61):
        assert got.level_for(float(r)) == want.level_for(float(r))
    for level in range(-1, got.n_levels + 2):
        assert got.knobs(level) == want.knobs(level)


@pytest.mark.parametrize("kw", [
    dict(headrooms=(1.0,), alpha_scales=(2.0, 3.0), round_caps=(0,)),
    dict(headrooms=(0.5, 0.5), alpha_scales=(2.0, 3.0), round_caps=(0, 0)),
    dict(headrooms=(1.0,), alpha_scales=(0.5,), round_caps=(0,))])
def test_degrade_ladder_rejects_what_jax_rejects(kw):
    for cls in (DegradeLadder, JLadder):
        with pytest.raises(ValueError):
            cls(**kw)
