"""The port's mesh-resident corpus and sharded steps on the CPU, in-process.

Sizes are the JAX package's own sharded tests': a ragged corpus of C=41
docs over S=4 shards (docs_per_shard 11, valid_docs [11, 11, 11, 8]),
L=12, M=16, B=4 queries of T=8 tokens, N=16 candidates each. A port mesh is
a list of devices; here every shard sits on the CPU.

* the routing tables and ``shard_corpus``'s layout equal the JAX
  package's (numpy, exact), for S in {1, 2, 4} and the f32, int8 and
  residual formats;
* each step at S=1 equals JAX's step on ``jax.make_mesh((1,), ("data",))``
  run in-process (the JAX side under ``REPRO_KERNEL_IMPL=ref``, jitted;
  the port replays JAX's keys through ``JaxReplayDraws``): ids exact,
  scores to rtol=1e-5 / atol=1e-6 (the two frameworks sum a doc's cells in
  different orders), reveal fractions and stats exact;
* each step at S=4 equals an oracle composed from JAX's single-device
  scorers (``_local_maxsim_scores``, ``_budgeted_scores``,
  ``_pooled_rerank`` with that shard's keys) on each shard's routed
  candidates and a numpy merge (pads at the -3e38 sentinel, lower index
  first), at the same tolerances;
* JAX's own sharded claims: dense, budgeted at full budget, two-phase at
  full survivors and the hard-bound bandit at S=4 equal S=1; the merge
  masks pad ids; the ragged global-id clamp; ``_chunked_over_queries``'s
  shape errors; ``reshard``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.retrieval import service as J
from repro.retrieval.sharded import route_aligned as j_route_aligned
from repro.retrieval.sharded import route_batch as j_route_batch
from repro.retrieval.sharded import route_candidates as j_route_candidates
from repro.retrieval.sharded import shard_corpus as j_shard_corpus
from repro_torch.dist.fault import reshard
from repro_torch.dist.mesh import (Sharded, corpus_specs, make_host_mesh,
                                   make_mesh, place, shard_parts)
from repro_torch.kernels.quant import QuantTokens, corpus_nbytes
from repro_torch.retrieval import service as P
from repro_torch.retrieval.corpus import build_corpus
from repro_torch.retrieval.sharded import (route_aligned, route_batch,
                                           route_candidates, shard_corpus)
from test_torch_core import JaxReplayDraws
from test_torch_threads import cap_torch_threads

cap_torch_threads()

RTOL, ATOL = 1e-5, 1e-6
NEG = np.float32(-3e38)
REPLAY = JaxReplayDraws()
C, L, M, B, T, N = 41, 12, 16, 4, 8, 16
K = 5
HARD = dict(alpha_ef=1e9, block_docs=4, block_tokens=4)


@pytest.fixture(autouse=True)
def ref_lane(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "ref")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((C, L, M)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    msk = np.arange(L)[None] < rng.integers(4, L + 1, C)[:, None]
    q = rng.standard_normal((B, T, M)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    cand = np.stack([rng.choice(C, N, replace=False)
                     for _ in range(B)]).astype(np.int32)
    a = np.full((B, N, T), -1.0, np.float32)       # valid unit-cosine support
    b = np.ones((B, N, T), np.float32)
    pooled = np.where(msk[:, :, None], emb, 0.0).mean(1).astype(np.float32)
    return dict(emb=emb, msk=msk, q=q, cand=cand, a=a, b=b, pooled=pooled)


def _mesh(S):
    return (make_mesh((1,), ("data",), device="cpu") if S == 1 else
            make_mesh((2, 2), ("data", "model"), device="cpu"))


JMESH1 = jax.make_mesh((1,), ("data",))


def t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, label=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=label)


def _same_topk(got, want, label=""):
    """(scores, ids) pairs: ids exact, scores within RTOL/ATOL."""
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]),
                                  err_msg=label)
    _close(got[0], want[0], label)


# ---------------------------------------------------------------------------
# routing tables, mesh and placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,n_local", [(1, None), (2, None), (4, None),
                                       (4, 9)])
def test_routing_tables_equal_jax(data, S, n_local):
    rng = np.random.default_rng(S)
    cand = data["cand"].copy()
    cand[rng.random(cand.shape) < 0.2] = -1            # -1 padding
    dps = -(-C // S)
    kw = {} if n_local is None else dict(n_local=n_local)
    got = route_candidates(cand, dps, S, **kw)
    np.testing.assert_array_equal(got, j_route_candidates(cand, dps, S, **kw))
    payloads = [data["a"], rng.random((B, N)).astype(np.float32)]
    cl, routed = route_batch(cand, payloads, dps, S, **kw)
    jcl, jrouted = j_route_batch(cand, payloads, dps, S, **kw)
    np.testing.assert_array_equal(cl, jcl)
    for x, y in zip(routed, jrouted):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        route_aligned(payloads[1], cand, got, dps),
        j_route_aligned(payloads[1], cand, got, dps))


def test_routing_raises_as_jax(data):
    for args, kw in (((data["cand"], 11, 4), dict(n_local=2)),
                     ((data["cand"] + 100, 11, 4), {})):
        with pytest.raises(ValueError) as ours:
            route_candidates(*args, **kw)
        with pytest.raises(ValueError) as theirs:
            j_route_candidates(*args, **kw)
        assert str(ours.value) == str(theirs.value)


def test_mesh_order_and_placement_table():
    mesh = make_mesh((2, 3), ("data", "model"), device="cpu")
    assert mesh.size == 6 and mesh.shape == {"data": 2, "model": 3}
    # Row-major: the shard at (data=1, model=1) is shard 4, the 5th device.
    assert P._shard_index(mesh, {"data": 1, "model": 1}) == 4
    assert [P._shard_index(mesh, {"data": d, "model": m})
            for d in range(2) for m in range(3)] == list(range(6))
    assert [s for s, _ in P._shards(mesh)] == list(range(6))
    specs = corpus_specs(mesh)
    assert specs["embs"] == specs["mask"] == specs["scales"] == 0
    assert specs["codebook"] is None and specs["centroids"] is None
    assert make_host_mesh(4, device="cpu").shape == {"data": 1, "model": 4}
    assert make_host_mesh(6, device="cpu").shape == {"data": 3, "model": 2}
    with pytest.raises(ValueError):
        make_mesh((2,), ("data",), device="cpu", devices=["cpu"])


def test_placement_views_one_copy_per_device():
    x = torch.arange(24.0).reshape(8, 3)
    mesh = _mesh(4)
    sh = place(x, mesh, 0)
    assert sh.shape == (8, 3) and sh.whole.data_ptr() == x.data_ptr()
    for s, p in enumerate(sh.parts):
        assert p.data_ptr() == x[2 * s].data_ptr()         # a view, no copy
    assert torch.equal(sh.gather(), x)
    rep = place(x, mesh, None)
    assert all(p is x for p in rep.parts)
    assert shard_parts(sh, mesh) is sh.parts
    with pytest.raises(ValueError):
        place(torch.zeros(6, 2), mesh, 0)                  # 6 rows, 4 shards
    # Shards on different devices each hold only their own rows.
    two = make_mesh((2,), ("data",), devices=["cpu", "meta"])
    sh2 = place(x, two, 0)
    assert sh2.whole is None and sh2.parts[1].device.type == "meta"
    assert sh2.parts[0].data_ptr() != x.data_ptr()
    assert sh2.parts[0].untyped_storage().nbytes() == 4 * 3 * 4


@pytest.mark.parametrize("fmt", ["bf16", "int8", "residual"])
@pytest.mark.parametrize("S", [1, 2, 4])
def test_shard_corpus_layout_equals_jax(data, S, fmt):
    mesh = (_mesh(S) if S != 2 else
            make_mesh((2,), ("data",), device="cpu"))
    jmesh = jax.make_mesh((1,), ("data",))
    sc = shard_corpus(data["emb"], data["msk"], mesh, corpus_format=fmt,
                      pooled=data["pooled"])
    dps = -(-C // S)
    want_valid = np.clip(C - dps * np.arange(S), 0, dps)
    assert (sc.n_shards, sc.docs_per_shard, sc.padded_docs) == (S, dps,
                                                                S * dps)
    np.testing.assert_array_equal(sc.valid_docs, want_valid)
    np.testing.assert_array_equal(sc.valid_docs_device().numpy(),
                                  want_valid)
    # The JAX package's placement of the same corpus, gathered whole.
    jsc = j_shard_corpus(data["emb"], data["msk"], jmesh,
                         corpus_format=fmt)
    full = sc.embs.gather()
    np.testing.assert_array_equal(sc.mask.gather().numpy()[:C],
                                  np.asarray(jsc.mask))
    assert not sc.mask.gather()[C:].any()
    np.testing.assert_array_equal(sc.pooled.gather().numpy()[:C],
                                  data["pooled"])
    if fmt == "bf16":
        assert full.dtype == torch.float32
        np.testing.assert_array_equal(full.numpy()[:C], data["emb"])
        assert not full[C:].any()
        return
    assert isinstance(full, QuantTokens) and full.fmt == fmt
    # Encoding is row-local, so the padded encoding's real rows equal the
    # JAX encoding of the unpadded corpus; int8 pad rows encode with scale
    # 0, residual ones with code 0 (they decode to centroids[0]).
    jq = jsc.embs
    np.testing.assert_array_equal(full.data.numpy()[:C], np.asarray(jq.data))
    np.testing.assert_array_equal(full.scales.float().numpy()[:C],
                                  np.asarray(jq.scales, np.float32))
    if fmt == "int8":
        assert not full.scales[C:].float().any()
    else:
        assert not full.codes[C:].any()
    if fmt == "residual":
        np.testing.assert_array_equal(full.codes.numpy()[:C],
                                      np.asarray(jq.codes))
        for p in sc.embs.parts:
            assert p.codebook is full.codebook        # whole on every shard
    for s, p in enumerate(sc.embs.parts):
        assert p.data.shape == (dps, L, M)
        assert p.data.data_ptr() == full.data[s * dps].data_ptr()


def test_build_corpus_on_a_mesh_matches_shard_corpus(data):
    mesh = _mesh(4)
    corpus = build_corpus(data["emb"], data["msk"], mesh=mesh,
                          n_centroids=4, pooled=data["pooled"], device="cpu")
    sc = shard_corpus(data["emb"], data["msk"], mesh, n_centroids=4)
    assert corpus.mesh is mesh and corpus.n_shards == 4
    assert corpus.padded_docs == 44 and corpus.n_docs == C
    np.testing.assert_array_equal(corpus.valid_docs, [11, 11, 11, 8])
    assert torch.equal(corpus.embs.gather(), sc.embs.gather())
    assert torch.equal(corpus.router.centroids, sc.router.centroids)
    assert torch.equal(corpus.router_arrays()[1], sc.router.shard_mass)
    # The router built at shard time counts docs per (centroid, shard).
    mass = corpus.router.shard_mass.numpy()
    np.testing.assert_array_equal(mass.sum(0), [11, 11, 11, 8])
    jsc = j_shard_corpus(data["emb"], data["msk"], jax.make_mesh(
        (1,), ("data",)), n_centroids=4)
    np.testing.assert_array_equal(corpus.router.centroids.numpy(),
                                  np.asarray(jsc.router.centroids))
    nbytes = corpus_nbytes(corpus.embs.whole)
    assert nbytes == 44 * L * M * 4


def test_reshard_places_a_host_tree_by_its_specs(data):
    mesh = _mesh(4)
    tree = {"embs": np.zeros((8, L, M), np.float32),
            "router": (np.ones((3, M), np.float32), [np.arange(4.0)])}
    specs = {"embs": 0, "router": (None, [0])}
    out = reshard(tree, specs, mesh)
    assert isinstance(out["embs"], Sharded) and out["embs"].dim == 0
    assert [tuple(p.shape) for p in out["embs"].parts] == [(2, L, M)] * 4
    assert out["router"][0].dim is None
    assert out["router"][0].shape == (3, M)
    assert [p.tolist() for p in out["router"][1][0].parts] == [
        [0.0], [1.0], [2.0], [3.0]]
    with pytest.raises(ValueError):
        reshard({"embs": tree["embs"]}, {"embs": 0, "x": 0}, mesh)


# ---------------------------------------------------------------------------
# helpers of the mesh half
# ---------------------------------------------------------------------------

def test_merge_scorecards_masks_pad_ids():
    """A shard with fewer than topk valid candidates ships -1-gid pad slots
    whose raw 0.0 scores must not beat real negative scores; the genuine
    shortfall comes back as -1 ids (JAX's regression test, in-process)."""
    NL, topk = 3, 8
    gids = np.full((2, 4, NL), -1, np.int64)
    scores = np.zeros((2, 4, NL), np.float32)
    rng = np.random.default_rng(1)
    for s in range(3):
        for j in range([2, 3, 1][s]):
            gids[:, s, j] = s * 10 + j
            scores[:, s, j] = -1.0 - rng.random((2,))
    best, ids = P._merge_scorecards(
        [t(scores[:, s]) for s in range(4)],
        [t(gids[:, s]) for s in range(4)], topk, torch.device("cpu"))
    best, ids = best.numpy(), ids.numpy()
    for r in range(2):
        assert set(ids[r, :6]) == {0, 1, 10, 11, 12, 20}
        assert (ids[r, 6:] == -1).all() and (best[r, :6] < 0).all()


@pytest.mark.parametrize("n_docs", [5, 7, 13, 41, 42, 64])
def test_shard_global_ids_ragged_clamp(n_docs):
    c_loc = -(-n_docs // 4)
    valid = np.clip(n_docs - c_loc * np.arange(4), 0, c_loc)
    slots = torch.arange(c_loc)[None]
    gids = torch.cat([P._shard_global_ids(slots, c_loc, s, list(valid))
                      for s in range(4)], dim=1).reshape(-1).numpy()
    kept = np.sort(gids[gids >= 0])
    np.testing.assert_array_equal(kept, np.arange(n_docs))  # no aliasing
    assert (gids == -1).sum() == 4 * c_loc - n_docs


def test_chunked_over_queries_shapes():
    x = torch.arange(8.0).reshape(8, 1)
    assert torch.equal(P._chunked_over_queries(
        lambda a: a[0] * 2, (x,), chunk=2), x * 2)
    with pytest.raises(ValueError, match="per chunk"):
        P._chunked_over_queries(lambda a: a[0][:, :, None], (x,), chunk=2)
    with pytest.raises(ValueError, match="2-D"):
        P._chunked_over_queries(lambda a: a[0].reshape(-1), (x,), chunk=3)


# ---------------------------------------------------------------------------
# S = 1 against JAX's steps on a one-device mesh
# ---------------------------------------------------------------------------

def _jax_call(step, *args):
    return jax.block_until_ready(jax.jit(step)(*args))


def test_mesh1_dense_budgeted_two_phase_equal_jax(data):
    mesh1 = _mesh(1)
    e, m, q, cl = (t(data["emb"]), t(data["msk"]), t(data["q"]),
                   t(data["cand"][:, None]))
    je, jm, jq, jcl = (jnp.asarray(data["emb"]), jnp.asarray(data["msk"]),
                       jnp.asarray(data["q"]), jnp.asarray(data["cand"][:, None]))
    got = P.make_rerank_dense_step(mesh1, topk=K)(e, m, q, cl)
    want = _jax_call(J.make_rerank_dense_step(JMESH1, topk=K), je, jm, jq, jcl)
    _same_topk(got, want, "dense")
    rng = np.random.default_rng(3)
    tok = rng.integers(-1, T, (B, 1, N, 3)).astype(np.int32)   # -1 pads clamp
    got = P.make_rerank_budgeted_step(mesh1, topk=K, tokens_per_doc=3)(
        e, m, q, cl, t(tok))
    want = _jax_call(J.make_rerank_budgeted_step(JMESH1, topk=K,
                                                 tokens_per_doc=3),
                     je, jm, jq, jcl, jnp.asarray(tok))
    _same_topk(got, want, "budgeted")
    for surv in (N, 2):
        got = P.make_rerank_two_phase_step(mesh1, topk=K, survivors=surv)(
            e, m, t(data["pooled"]), q, cl)
        want = _jax_call(J.make_rerank_two_phase_step(
            JMESH1, topk=K, survivors=surv), je, jm,
            jnp.asarray(data["pooled"]), jq, jcl)
        _same_topk(got, want, f"two_phase survivors={surv}")


def _sharded_args(data, fmt="bf16"):
    return (data["q"], data["cand"][:, None], data["a"][:, None],
            data["b"][:, None])


@pytest.mark.parametrize("flavor,fmt", [("dense", "bf16"),
                                        ("bandit", "bf16"),
                                        ("dense", "int8"),
                                        ("bandit", "residual")])
def test_mesh1_sharded_serving_step_equals_jax(data, flavor, fmt):
    """make_sharded_serving_step at S=1 on every format, with a failed-free
    health mask and the fidelity knobs given (the engine's call)."""
    kw = dict(HARD, max_rounds=-1) if flavor == "bandit" else {}
    sc = shard_corpus(data["emb"], data["msk"], _mesh(1), corpus_format=fmt)
    jsc = j_shard_corpus(data["emb"], data["msk"], JMESH1,
                         corpus_format=fmt)
    q, cl, a, b = _sharded_args(data)
    got = P.make_sharded_serving_step(
        _mesh(1), flavor, topk=K, corpus_format=fmt, base_seed=7,
        draws=REPLAY, **kw)(sc.embs, sc.mask, t(q), t(cl), t(a), t(b),
                            sc.valid_docs, 3, np.ones(1, bool), 1.0, 0)
    want = _jax_call(J.make_sharded_serving_step(
        JMESH1, flavor, topk=K, corpus_format=fmt, base_seed=7, **kw),
        jsc.embs, jsc.mask, jnp.asarray(q), jnp.asarray(cl), jnp.asarray(a),
        jnp.asarray(b), jsc.valid_docs_device(), jnp.int32(3),
        jnp.ones((1,), bool), jnp.float32(1.0), jnp.int32(0))
    _same_topk(got[:2], want[:2], f"{flavor}/{fmt}")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert got[3].shape == (1, 4)


def test_mesh1_bandit_query_placement_equals_jax(data):
    e, m = t(data["emb"]), t(data["msk"])
    docs, dmask = P.gather_candidates(e, m, t(data["cand"]))
    args = (docs, dmask, t(data["q"]), t(data["cand"]), t(data["a"]),
            t(data["b"]))
    step, in_specs, out_specs = P.make_rerank_bandit_step(
        _mesh(1), topk=K, draws=REPLAY, **HARD)
    assert in_specs == (0,) * 6 and out_specs == (0, 0)
    got = step(*args)
    jstep, _, _ = J.make_rerank_bandit_step(JMESH1, topk=K, **HARD)
    want = _jax_call(jstep, *(jnp.asarray(x.numpy()) for x in args))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # The batch split over 4 shards: each shard's pooled loop over its own
    # queries equals the one loop over the whole batch (growth off).
    step4, _, _ = P.make_rerank_bandit_step(_mesh(4), topk=K, draws=REPLAY,
                                            **HARD)
    got4 = step4(*args)
    assert torch.equal(got4[0], got[0]) and torch.equal(got4[1], got[1])
    with pytest.raises(ValueError, match="placement"):
        P.make_rerank_bandit_step(_mesh(1), placement="edge")
    corpus = P.make_rerank_bandit_step(_mesh(1), placement="corpus")
    assert callable(corpus)


# ---------------------------------------------------------------------------
# S = 4 against the composed JAX oracle
# ---------------------------------------------------------------------------

def _np_topk(x, k):
    """Stable top-k along the last axis: values descending, ties by lower
    index (``jax.lax.top_k``'s order)."""
    pos = np.argsort(-x, axis=-1, kind="stable")[..., :k]
    return np.take_along_axis(x, pos, -1), pos


def _np_merge(cards, topk):
    """The numpy scorecard merge: pads at the sentinel, per-shard top-K,
    shard-major concatenation, global top-K, -1 for a shortfall."""
    all_s, all_g = [], []
    for sc, g in cards:
        sc = np.where(g >= 0, sc, NEG).astype(np.float32)
        if sc.shape[1] > topk:
            sc, pos = _np_topk(sc, topk)
            g = np.take_along_axis(g, pos, 1)
        all_s.append(sc)
        all_g.append(g)
    s, g = np.concatenate(all_s, 1), np.concatenate(all_g, 1)
    s = np.where(g >= 0, s, NEG)
    best, pos = _np_topk(s, topk)
    ids = np.take_along_axis(g, pos, 1)
    return best, np.where(best > NEG / 2, ids, -1)


def _oracle_shards(data, S, healthy=None):
    """Per shard: its padded rows, routed local slots, global ids and the
    valid mask, as JAX's sharded step derives them."""
    dps = -(-C // S)
    pad = S * dps - C
    emb = np.pad(data["emb"], ((0, pad), (0, 0), (0, 0)))
    msk = np.pad(data["msk"], ((0, pad), (0, 0)))
    valid_docs = np.clip(C - dps * np.arange(S), 0, dps)
    cl = route_candidates(data["cand"], dps, S)
    a_l = route_aligned(data["a"], data["cand"], cl, dps)
    b_l = route_aligned(data["b"], data["cand"], cl, dps)
    out = []
    for s in range(S):
        cand = cl[:, s]
        ok = (cand >= 0) & (cand < valid_docs[s])
        if healthy is not None:
            ok &= healthy[s]
        gids = np.where(ok, cand + s * dps, -1)
        out.append(dict(embs=jnp.asarray(emb[s * dps:(s + 1) * dps]),
                        mask=jnp.asarray(msk[s * dps:(s + 1) * dps]),
                        cand=cand, gids=gids, valid=ok, a=a_l[:, s],
                        b=b_l[:, s]))
    return out, cl, a_l, b_l, valid_docs


@functools.lru_cache(maxsize=None)
def _j_pooled(cfg):
    return jax.jit(lambda d, m, q, c, a, b, k: J._pooled_rerank(
        d, m, q, c, a, b, k, cfg))


@functools.lru_cache(maxsize=None)
def _j_dense():
    return jax.jit(J._local_maxsim_scores)


def _oracle_step(data, flavor, shards, base_seed, seed, k_shard):
    """JAX's single-device scorers per shard, then the numpy merge."""
    cards, revs, cells, stats = [], [], [], []
    jq = jnp.asarray(data["q"])
    for s, sh in enumerate(shards):
        docs, dmask = J.gather_candidates(sh["embs"], sh["mask"],
                                          jnp.asarray(sh["cand"]))
        dmask = dmask & jnp.asarray(sh["valid"])[:, :, None]
        n_cells = (sh["valid"].sum(1) * T).astype(np.float32)
        gids = jnp.asarray(sh["gids"])
        if flavor == "dense":
            sc = np.asarray(_j_dense()(docs, dmask, jq))
            sc = np.where(sh["valid"], sc, NEG).astype(np.float32)
            best, pos = _np_topk(sc, k_shard)
            cards.append((best, np.take_along_axis(sh["gids"], pos, 1)))
            revs.append(n_cells)
            stats.append(np.array([1.0, 0.0, 0.0, 0.0], np.float32))
        else:
            key = jax.random.fold_in(jax.random.fold_in(
                jax.random.key(base_seed), seed), s)
            cfg = J.BatchedConfig(k=k_shard, delta=0.01, alpha_ef=1e9,
                                  block_docs=4, block_tokens=4,
                                  max_rounds=-1)
            best, bg, cov, st = _j_pooled(cfg)(
                docs, dmask, jq, gids, jnp.asarray(sh["a"]),
                jnp.asarray(sh["b"]), jax.random.split(key, B))
            cards.append((np.asarray(best), np.asarray(bg)))
            revs.append(np.asarray(cov) * n_cells)
            stats.append(np.asarray(st))
        cells.append(n_cells)
    tot_rev, tot_cells = revs[0], cells[0]
    for r, c in zip(revs[1:], cells[1:]):
        tot_rev, tot_cells = tot_rev + r, tot_cells + c
    best, ids = _np_merge(cards, K)
    return best, ids, tot_rev / np.maximum(tot_cells, np.float32(1.0)), \
        np.stack(stats)


@pytest.mark.parametrize("flavor", ["dense", "bandit"])
def test_mesh4_sharded_step_equals_composed_jax_oracle(data, flavor):
    shards, cl, a_l, b_l, vd = _oracle_shards(data, 4)
    sc = shard_corpus(data["emb"], data["msk"], _mesh(4))
    kw = dict(HARD, max_rounds=-1) if flavor == "bandit" else {}
    got = P.make_sharded_serving_step(
        _mesh(4), flavor, topk=K, base_seed=7, draws=REPLAY, **kw)(
        sc.embs, sc.mask, t(data["q"]), t(cl), t(a_l), t(b_l),
        sc.valid_docs, 3)
    want = _oracle_step(data, flavor, shards, 7, 3, K)
    _same_topk(got[:2], want[:2], flavor)
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_array_equal(got[3].numpy(), want[3])


def test_mesh4_failed_shard_equals_oracle_with_its_mask(data):
    """A failed shard's candidates become pads: its docs leave the merge
    and the reveal fraction counts only the healthy corpus."""
    healthy = np.array([True, False, True, True])
    shards, cl, a_l, b_l, vd = _oracle_shards(data, 4, healthy)
    sc = shard_corpus(data["emb"], data["msk"], _mesh(4))
    got = P.make_sharded_serving_step(
        _mesh(4), "bandit", topk=K, draws=REPLAY, **HARD)(
        sc.embs, sc.mask, t(data["q"]), t(cl), t(a_l), t(b_l),
        sc.valid_docs, 0, healthy)
    want = _oracle_step(data, "bandit", shards, 0, 0, K)
    _same_topk(got[:2], want[:2], "failover")
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    ids = got[1].numpy()
    assert not ((ids >= 11) & (ids < 22)).any()


def test_mesh4_dense_budgeted_two_phase_equal_composed_oracle(data):
    shards, cl, _, _, vd = _oracle_shards(data, 4)
    sc = shard_corpus(data["emb"], data["msk"], _mesh(4),
                      pooled=data["pooled"])
    q = t(data["q"])
    want = _oracle_step(data, "dense", shards, 0, 0, K)[:2]
    got = P.make_rerank_dense_step(_mesh(4), topk=K, valid_docs=vd)(
        sc.embs, sc.mask, q, t(cl))
    _same_topk(got, want, "dense")
    # budgeted at 3 tokens per doc: JAX's _budgeted_scores per shard
    rng = np.random.default_rng(4)
    tok = rng.integers(-1, T, (B, N, 3)).astype(np.int32)
    tok_l = route_aligned(tok, data["cand"], cl, sc.docs_per_shard)
    cards = []
    for s, sh in enumerate(shards):
        docs, dmask = J.gather_candidates(sh["embs"], sh["mask"],
                                          jnp.asarray(sh["cand"]))
        scores = np.asarray(jax.jit(J._budgeted_scores)(
            docs, dmask, jnp.asarray(data["q"]), jnp.asarray(tok_l[:, s])))
        cards.append((scores, sh["gids"]))
    got = P.make_rerank_budgeted_step(_mesh(4), topk=K, tokens_per_doc=3,
                                      valid_docs=vd)(
        sc.embs, sc.mask, q, t(cl), t(tok_l))
    _same_topk(got, _np_merge(cards, K), "budgeted")


def test_mesh4_flavors_equal_single_device(data):
    """JAX's own claims, ported: dense, budgeted at full budget and
    two-phase at full survivors on the ragged 4-shard corpus equal the
    1-shard top-K, and so does the hard-bound bandit."""
    sc4 = shard_corpus(data["emb"], data["msk"], _mesh(4),
                       pooled=data["pooled"])
    cl4 = route_candidates(data["cand"], 11, 4)
    e, m, q = t(data["emb"]), t(data["msk"]), t(data["q"])
    cl1 = t(data["cand"][:, None])
    d1 = P.make_rerank_dense_step(_mesh(1), topk=K)(e, m, q, cl1)
    d4 = P.make_rerank_dense_step(_mesh(4), topk=K,
                                  valid_docs=sc4.valid_docs)(
        sc4.embs, sc4.mask, q, t(cl4))
    tok = np.broadcast_to(np.arange(T, dtype=np.int32)[None, None],
                          (B, N, T))
    b4 = P.make_rerank_budgeted_step(_mesh(4), topk=K, tokens_per_doc=T,
                                     valid_docs=sc4.valid_docs)(
        sc4.embs, sc4.mask, q, t(cl4),
        t(route_aligned(tok, data["cand"], cl4, 11)))
    t4 = P.make_rerank_two_phase_step(_mesh(4), topk=K, survivors=N,
                                      valid_docs=sc4.valid_docs)(
        sc4.embs, sc4.mask, sc4.pooled, q, t(cl4))
    a4 = route_aligned(data["a"], data["cand"], cl4, 11)
    b4_ = route_aligned(data["b"], data["cand"], cl4, 11)
    bandit = P.make_rerank_bandit_step(_mesh(4), topk=K, draws=REPLAY,
                                       max_rounds=-1, placement="corpus",
                                       **HARD)(
        sc4.embs, sc4.mask, q, t(cl4), t(a4), t(b4_), sc4.valid_docs, 0)
    stats = bandit[3].numpy()
    assert stats.shape == (4, 4) and (stats[:, 3] == 0).all()
    assert ((bandit[2] > 0) & (bandit[2] <= 1)).all()
    for label, got in (("dense", d4), ("budgeted", b4), ("two_phase", t4),
                       ("bandit", bandit[:2])):
        for r in range(B):
            assert set(got[1][r].tolist()) == set(d1[1][r].tolist()), label
        np.testing.assert_allclose(np.sort(got[0].numpy(), 1),
                                   np.sort(d1[0].numpy(), 1), rtol=RTOL,
                                   atol=ATOL, err_msg=label)


def test_sharded_int8_equals_one_shard_int8(data):
    """Sharding and quantization commute: an int8 corpus over 4 shards
    returns the 1-shard int8 top-K for both flavors, and its resident bytes
    are >= 3.5x below f32."""
    q = t(data["q"])
    cl4 = route_candidates(data["cand"], 11, 4)
    a4 = route_aligned(data["a"], data["cand"], cl4, 11)
    b4 = route_aligned(data["b"], data["cand"], cl4, 11)
    sc4 = shard_corpus(data["emb"], data["msk"], _mesh(4),
                       corpus_format="int8")
    sc1 = shard_corpus(data["emb"], data["msk"], _mesh(1),
                       corpus_format="int8")
    f32 = shard_corpus(data["emb"], data["msk"], _mesh(4))
    assert corpus_nbytes(f32.embs.whole) / corpus_nbytes(sc4.embs.whole) \
        >= 3.5
    for flavor, kw in (("dense", {}), ("bandit", HARD)):
        g4 = P.make_sharded_serving_step(
            _mesh(4), flavor, topk=K, corpus_format="int8", draws=REPLAY,
            **kw)(sc4.embs, sc4.mask, q, t(cl4), t(a4), t(b4),
                  sc4.valid_docs, 0)
        g1 = P.make_sharded_serving_step(
            _mesh(1), flavor, topk=K, corpus_format="int8", draws=REPLAY,
            **kw)(sc1.embs, sc1.mask, q, t(data["cand"][:, None]),
                  t(data["a"][:, None]), t(data["b"][:, None]),
                  sc1.valid_docs, 0)
        for r in range(B):
            assert set(g4[1][r].tolist()) == set(g1[1][r].tolist()), flavor
    with pytest.raises(ValueError, match="built for a 'bf16'"):
        P.make_sharded_serving_step(_mesh(4), "dense", topk=K)(
            sc4.embs, sc4.mask, q, t(cl4), t(a4), t(b4), sc4.valid_docs, 0)
    with pytest.raises(ValueError, match="dense"):
        P.make_rerank_budgeted_step(_mesh(4), topk=K)(
            sc4.embs, sc4.mask, q, t(cl4), t(np.zeros((B, 4, N, 2), int)))


def test_sharded_step_guards(data):
    sc = shard_corpus(data["emb"], data["msk"], _mesh(4))
    cl = route_candidates(data["cand"], 11, 4)
    z = np.zeros(cl.shape + (T,), np.float32)
    with pytest.raises(ValueError, match="flavor"):
        P.make_sharded_serving_step(_mesh(4), "sparse")
    with pytest.raises(ValueError, match="routed for"):
        P.make_sharded_serving_step(_mesh(4), "dense")(
            sc.embs, sc.mask, t(data["q"]), t(cl[:, :2]), t(z[:, :2]),
            t(z[:, :2]), sc.valid_docs, 0)
    with pytest.raises(ValueError, match="global top-"):
        P.make_sharded_serving_step(_mesh(4), "dense", topk=9)(
            sc.embs, sc.mask, t(data["q"]), t(cl[..., :2]),
            t(z[:, :, :2]), t(z[:, :, :2]), sc.valid_docs, 0)
