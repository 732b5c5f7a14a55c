"""The port's corpus module (``repro_torch.retrieval.corpus``) against the
JAX package's ``repro.retrieval.corpus``, on the CPU.

``build_router`` is a verbatim numpy copy, so centroids and the mass table
are bit-equal. ``route_quotas`` is exact on the same mass; ``route_mass``
sums its affinities in another order and matches at rtol=1e-5.
``build_corpus`` leaves are bit-equal for all three formats, and the
leaf-wise gather with -1 ids equals JAX's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import make_retrieval_dataset
from repro.retrieval import corpus as jc
from repro.retrieval.index import build_index
from repro_torch.dist.mesh import make_mesh
from repro_torch.retrieval import corpus as tc
from repro_torch.retrieval.index import from_numpy
from repro_torch.retrieval.service import gather_candidates
from test_torch_threads import cap_torch_threads

cap_torch_threads()

RTOL, ATOL = 1e-5, 1e-6


def _dataset(seed, **kw):
    args = dict(n_docs=40, n_queries=3, doc_len=12, min_doc_len=3,
                query_len=8, dim=16, seed=seed)
    args.update(kw)
    return make_retrieval_dataset(**args)


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


def _same(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n_shards,dead", [(1, ()), (4, (3, 17))])
def test_build_router_is_bit_equal(n_shards, dead):
    ds = _dataset(1)
    mask = ds.doc_mask.copy()
    mask[list(dead)] = False                  # docs that carry no mass
    kw = dict(n_shards=n_shards, docs_per_shard=-(-40 // n_shards),
              n_centroids=6, n_iters=5, seed=3)
    want = jc.build_router(ds.doc_embs, mask, **kw)
    got = tc.build_router(ds.doc_embs, mask, device="cpu", **kw)
    _same(got.centroids, want.centroids)
    _same(got.shard_mass, want.shard_mass)
    np.testing.assert_array_equal(got.valid_docs, want.valid_docs)
    assert (got.n_centroids, got.n_shards) == (want.n_centroids,
                                               want.n_shards)


def test_build_router_with_no_valid_doc():
    ds = _dataset(2, n_docs=4)
    mask = np.zeros_like(ds.doc_mask)
    want = jc.build_router(ds.doc_embs, mask, n_shards=2, docs_per_shard=2)
    got = tc.build_router(ds.doc_embs, mask, n_shards=2, docs_per_shard=2,
                          device="cpu")
    _same(got.centroids, want.centroids)
    _same(got.shard_mass, want.shard_mass)


@pytest.mark.parametrize("n_centroids", [5, 1])
def test_route_mass_matches(n_centroids):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 8, 16)).astype(np.float32)
    q[1, 5:] = 0.0                              # zero-padded query tokens
    cents = rng.standard_normal((n_centroids, 16)).astype(np.float32)
    mass = rng.integers(0, 9, (n_centroids, 4)).astype(np.float32)
    want = jc.route_mass(jnp.asarray(q), jnp.asarray(cents),
                         jnp.asarray(mass))
    got = tc.route_mass(torch.from_numpy(q), torch.from_numpy(cents),
                        torch.from_numpy(mass))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    empty = tc.route_mass(torch.from_numpy(q), torch.zeros((0, 16)),
                          torch.zeros((0, 4)))
    assert empty.shape == (3, 4) and not empty.any()


HEALTHY = {"all": None, "one-down": [True, False, True, True, True],
           "none-with-mass": [False, True, False, False, False],
           "all-down": [False] * 5}


@pytest.mark.parametrize("healthy", list(HEALTHY))
@pytest.mark.parametrize("n_total", [1, 7, 64])
def test_route_quotas_are_exact(healthy, n_total):
    rng = np.random.default_rng(n_total)
    mass = rng.random((6, 5)).astype(np.float32) * 10
    mass[0] = 0.0                                 # uniform fallback row
    mass[1] = [3.0, 3.0, 3.0, 0.0, 0.0]           # exact ties
    mass[2] = [0.0, 0.0, 0.0, 0.0, 2.0]           # only a shard that may die
    mass[2, 1] = 0.0 if healthy == "none-with-mass" else mass[2, 1]
    h = HEALTHY[healthy]
    want = jc.route_quotas(jnp.asarray(mass), n_total,
                           healthy=None if h is None else jnp.asarray(h))
    got = tc.route_quotas(torch.from_numpy(mass), n_total,
                          healthy=None if h is None else torch.tensor(h))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    assert (got.sum(-1) == n_total).all()


def test_router_route_matches_and_raises():
    ds = _dataset(5)
    kw = dict(n_shards=4, docs_per_shard=10, n_centroids=4, seed=1)
    want = jc.build_router(ds.doc_embs, ds.doc_mask, **kw)
    got = tc.build_router(ds.doc_embs, ds.doc_mask, device="cpu", **kw)
    np.testing.assert_array_equal(got.route(ds.queries, n_total=8),
                                  want.route(ds.queries, n_total=8))
    down = np.array([True, True, False, True])
    np.testing.assert_array_equal(
        got.route(ds.queries, n_total=8, healthy=down),
        want.route(ds.queries, n_total=8, healthy=down))
    with pytest.raises(ValueError, match="never silently clamped"):
        got.route(ds.queries, n_total=200)
    with pytest.raises(ValueError, match="n_local=1"):
        got.route(ds.queries, n_total=12, n_local=1)


@pytest.mark.parametrize("quotas,valid,n_local,match", [
    ([[3, 1], [1, 3]], [2, 5], None, "shard 0 exceeds its valid_docs=2"),
    ([2, 6], [9, 5], None, "shard 1 exceeds its valid_docs=5"),
    ([[3, 1], [1, 3]], [9, 9], 2, "capacity n_local=2")])
def test_validate_quotas_messages_match(quotas, valid, n_local, match):
    messages = []
    for fn in (jc.validate_quotas, tc.validate_quotas):
        with pytest.raises(ValueError, match=match) as err:
            fn(np.asarray(quotas), np.asarray(valid), n_local=n_local)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    tc.validate_quotas(np.asarray([[1, 1]]), np.asarray([1, 1]), n_local=1)


@pytest.mark.parametrize("fmt", ["bf16", "int8", "residual"])
def test_build_corpus_leaves_are_bit_equal(fmt):
    ds = _dataset(6)
    want = jc.build_corpus(ds.doc_embs, ds.doc_mask, corpus_format=fmt)
    got = tc.build_corpus(ds.doc_embs, ds.doc_mask, corpus_format=fmt,
                          device="cpu")
    assert got.fmt == want.fmt == fmt
    if fmt == "bf16":
        assert got.embs.dtype == torch.float32
        _same(got.embs, want.embs)
    else:
        assert got.embs.fmt == want.embs.fmt
        for g, w in zip(got.embs, want.embs):
            assert (g is None) == (w is None)
            if g is not None:
                _same(g, w)
    _same(got.mask, want.mask)
    for field in ("n_docs", "n_shards", "docs_per_shard"):
        assert getattr(got, field) == getattr(want, field), field
    np.testing.assert_array_equal(got.valid_docs, want.valid_docs)
    assert (got.router is None) == (want.router is None)
    if fmt == "residual":
        _same(got.router.centroids, want.router.centroids)
        _same(got.router.shard_mass, want.router.shard_mass)


def test_build_corpus_bf16_source_stays_bf16_and_router_is_optional():
    ds = _dataset(7)
    emb = torch.from_numpy(ds.doc_embs).to(torch.bfloat16)
    got = tc.build_corpus(emb, ds.doc_mask, n_centroids=3, device="cpu")
    assert got.embs.dtype == torch.bfloat16 and got.router.n_centroids == 3
    want = jc.build_corpus(jnp.asarray(ds.doc_embs).astype(jnp.bfloat16),
                           ds.doc_mask, n_centroids=3)
    _same(got.embs, want.embs)
    _same(got.router.centroids, want.router.centroids)


@pytest.mark.parametrize("fmt", ["bf16", "int8", "residual"])
def test_gather_tokens_with_padding_ids_matches(fmt):
    ds = _dataset(8)
    want = jc.build_corpus(ds.doc_embs, ds.doc_mask, corpus_format=fmt)
    got = tc.build_corpus(ds.doc_embs, ds.doc_mask, corpus_format=fmt,
                          device="cpu")
    ids = np.array([[3, -1, 7, 39], [-1, -1, 0, 5]])
    we, wm = jc.gather_tokens(want.embs, want.mask, jnp.asarray(ids))
    ge, gm = tc.gather_tokens(got.embs, got.mask, torch.from_numpy(ids))
    _same(gm, wm)
    assert not gm[0, 1].any() and not gm[1, :2].any()
    for g, w in zip(*(((ge,), (we,)) if fmt == "bf16" else (ge, we))):
        if g is not None:
            _same(g, w)


def test_gather_candidates_on_an_index_matches_jax_index_gather():
    ds = _dataset(9)
    idx = from_numpy(ds.doc_embs, ds.doc_mask, ds.doc_lens, device="cpu")
    jidx = build_index(ds.doc_embs, ds.doc_mask, ds.doc_lens)
    ids = np.array([[2, -1], [0, 11]])
    got = gather_candidates(idx.doc_embs, idx.doc_mask, torch.from_numpy(ids))
    want = jidx.gather_docs(jnp.asarray(ids))
    for g, w in zip(got, want):
        _same(g, w)


def test_build_corpus_guards():
    ds = _dataset(10, n_docs=6)
    # A mesh now places the corpus (retrieval.sharded); 6 docs over 4
    # shards pad to 8 rows with a ragged tail.
    sharded = tc.build_corpus(ds.doc_embs, ds.doc_mask, mesh=make_mesh(
        (4,), ("data",), device="cpu"), device="cpu")
    assert (sharded.n_shards, sharded.docs_per_shard) == (4, 2)
    np.testing.assert_array_equal(sharded.valid_docs, [2, 2, 2, 0])
    with pytest.raises(ValueError, match="unknown corpus format"):
        tc.build_corpus(ds.doc_embs, ds.doc_mask, corpus_format="fp4",
                        device="cpu")
    with pytest.raises(ValueError, match="corpus must be"):
        tc.build_corpus(ds.doc_embs[0], ds.doc_mask, device="cpu")
    assert tc.build_corpus(ds.doc_embs, ds.doc_mask,
                           device="cpu").router is None
