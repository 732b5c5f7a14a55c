"""Routed stage 1 and the engine's mesh paths on the CPU, in-process.

Sizes are the JAX package's routed tests': the ragged corpus C=41 over S=4
shards (valid_docs [11, 11, 11, 8]), L=12, M=16, B=4 queries of T=8
tokens. The JAX side runs under ``REPRO_KERNEL_IMPL=ref`` (jitted), the
port replays its keys (``JaxReplayDraws``).

* ``generate_candidates(quota=)`` equals JAX's (ids and masks exact,
  bounds to rtol=1e-5 / atol=1e-6: the two similarity products round
  differently);
* the routed step at S=1 equals JAX's on ``jax.make_mesh((1,), ("data",))``
  (quota-capped, with prereveal); at S=4 it equals an oracle composed
  from JAX's router, per-shard ``generate_candidates`` with the quota and
  ``_pooled_rerank`` with that shard's keys, merged in numpy; ids exact,
  scores to rtol=1e-5 / atol=1e-6, reveal fractions and stats exact;
* JAX's claims: routed equals the host-routed sharded step at full
  coverage (``kprime`` >= C_loc * L, ``n_local`` >= c_loc), and the
  quota-capped smoke;
* the engine: ``mesh_axes=(("data", 1),)`` against the JAX engine
  (``stage1="host"`` and ``"local"``, dense and bandit), and at S=4 zero
  rebuilds, per-shard metrics, shard failover / restore and the chaos
  plan's ``shard_down`` / ``shard_up``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import make_retrieval_dataset
from repro.retrieval import service as J
from repro.retrieval.ann import generate_candidates as j_generate
from repro.retrieval.corpus import route_mass as j_route_mass
from repro.retrieval.corpus import route_quotas as j_route_quotas
from repro.retrieval.sharded import shard_corpus as j_shard_corpus
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import RetrievalEngine as JRetrievalEngine
from repro_torch.dist.fault import FaultPlan, InjectedFault
from repro_torch.dist.mesh import make_mesh
from repro_torch.retrieval import service as P
from repro_torch.retrieval.ann import generate_candidates
from repro_torch.retrieval.pipeline import candidates_for
from repro_torch.retrieval.sharded import route_batch, shard_corpus
from repro_torch.serve import (AsyncRetrievalEngine, EngineConfig, Request,
                               RetrievalEngine)
from test_torch_core import JaxReplayDraws
from test_torch_sharded import _np_merge
from test_torch_threads import cap_torch_threads

cap_torch_threads()

pytestmark = pytest.mark.timeout(300)
RTOL, ATOL = 1e-5, 1e-6
NEG = np.float32(-3e38)
REPLAY = JaxReplayDraws()
C, L, M, B, T = 41, 12, 16, 4, 8
KP = 100_000                       # >> C * L: every doc is a stage-1 hit
K = 5
HARD = dict(alpha_ef=1e9, block_docs=4, block_tokens=4)
JMESH1 = jax.make_mesh((1,), ("data",))


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
    return dict(emb=emb, msk=msk, q=q)


def _mesh(S):
    return (make_mesh((1,), ("data",), device="cpu") if S == 1 else
            make_mesh((2, 2), ("data", "model"), device="cpu"))


def t(x):
    return torch.as_tensor(np.asarray(x))


def _same(got, want, label=""):
    """(scores, ids, frac, stats): ids exact, scores to RTOL/ATOL, reveal
    fraction and stats exact."""
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]),
                                  err_msg=label)
    np.testing.assert_allclose(got[0].numpy().astype(np.float64),
                               np.asarray(want[0], np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=label)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]),
                                  err_msg=label)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]),
                                  err_msg=label)


@pytest.mark.parametrize("quota", [None, 0, 3, 9, 40])
def test_generate_candidates_quota_equals_jax(data, quota):
    q = data["q"][1]
    got = generate_candidates(t(data["emb"]), t(data["msk"]), t(q), quota,
                              kprime=6, max_candidates=16)
    want = jax.jit(j_generate, static_argnames=("kprime", "max_candidates")
                   )(jnp.asarray(data["emb"]), jnp.asarray(data["msk"]),
                     jnp.asarray(q), None if quota is None
                     else jnp.int32(quota), kprime=6, max_candidates=16)
    for field in ("doc_ids", "doc_mask", "known_mask"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    for field in ("a", "b", "known_vals", "s_kprime"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=RTOL, atol=ATOL, err_msg=field)
    if quota is not None:
        assert int(got.doc_mask.sum()) <= quota
        # The kept candidates are the strongest: a quota of 3 keeps a
        # subset of the uncapped list.
        full = generate_candidates(t(data["emb"]), t(data["msk"]), t(q),
                                   kprime=6, max_candidates=16)
        assert set(got.doc_ids[got.doc_mask].tolist()) <= set(
            full.doc_ids[full.doc_mask].tolist())


def _routed_kw(flavor):
    return dict(HARD) if flavor == "bandit" else {}


@pytest.mark.parametrize("flavor,n_total,prereveal", [
    ("dense", 0, False), ("bandit", 0, False), ("bandit", 12, True)])
def test_mesh1_routed_step_equals_jax(data, flavor, n_total, prereveal):
    sc = shard_corpus(data["emb"], data["msk"], _mesh(1), n_centroids=4)
    jsc = j_shard_corpus(data["emb"], data["msk"], JMESH1, n_centroids=4)
    np.testing.assert_array_equal(sc.router.centroids.numpy(),
                                  np.asarray(jsc.router.centroids))
    kw = dict(topk=K, n_local=16, n_total=n_total, kprime=6,
              prereveal_ann=prereveal, base_seed=2, **_routed_kw(flavor))
    got = P.make_routed_serving_step(_mesh(1), flavor, draws=REPLAY, **kw)(
        sc.embs, sc.mask, sc.router.centroids, sc.router.shard_mass,
        t(data["q"]), sc.valid_docs, 5, np.ones(1, bool), 1.0, 0)
    want = jax.block_until_ready(jax.jit(J.make_routed_serving_step(
        JMESH1, flavor, **kw))(
        jsc.embs, jsc.mask, jsc.router.centroids, jsc.router.shard_mass,
        jnp.asarray(data["q"]), jsc.valid_docs_device(), jnp.int32(5),
        jnp.ones((1,), bool), jnp.float32(1.0), jnp.int32(0)))
    _same(got, want, flavor)
    assert got[3].shape == (1, 6)


def _routed_oracle(data, sc, n_local, n_total, kprime, base_seed, seed,
                   healthy=None):
    """JAX's routed step composed per shard: the replicated router and
    quota table, shard-local ``generate_candidates`` with the quota, the
    pooled rerank with prereveal on the shard's keys, the numpy merge."""
    dps, S = sc.docs_per_shard, sc.n_shards
    pad = S * dps - C
    emb = np.pad(data["emb"], ((0, pad), (0, 0), (0, 0)))
    msk = np.pad(data["msk"], ((0, pad), (0, 0)))
    jq = jnp.asarray(data["q"])
    cents = jnp.asarray(sc.router.centroids.numpy())
    mass = jnp.asarray(sc.router.shard_mass.numpy())
    m = j_route_mass(jq, cents, mass)
    hl = None if healthy is None else jnp.asarray(healthy)
    quota = np.asarray(j_route_quotas(m, n_total, healthy=hl))
    share = quota.astype(np.float32) / np.float32(n_total)
    gen = jax.jit(jax.vmap(lambda e, mk, qq, nq: j_generate(
        e, mk, qq, nq, kprime=kprime, max_candidates=n_local),
        in_axes=(None, None, 0, 0)))
    k_shard = min(K, n_local)
    cfg = J.BatchedConfig(k=k_shard, delta=0.01, alpha_ef=0.3, block_docs=4,
                          block_tokens=4, max_rounds=-1)
    rerank = jax.jit(lambda d, mk, q, c, a, b, k, pr, pv: J._pooled_rerank(
        d, mk, q, c, a, b, k, cfg, prereveal=pr, prereveal_vals=pv))
    cards, revs, cells, stats = [], [], [], []
    for s in range(S):
        e = jnp.asarray(emb[s * dps:(s + 1) * dps])
        mk = jnp.asarray(msk[s * dps:(s + 1) * dps])
        cand = gen(e, mk, jq, jnp.asarray(quota[:, s]))
        ids = np.asarray(cand.doc_ids)
        ok = (ids >= 0) & (ids < sc.valid_docs[s])
        if healthy is not None:
            ok &= healthy[s]
        gids = np.where(ok, ids + s * dps, -1)
        docs, dmask = J.gather_candidates(e, mk, cand.doc_ids)
        dmask = dmask & jnp.asarray(ok)[:, :, None]
        n_cells = (ok.sum(1) * T).astype(np.float32)
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.key(base_seed), seed), s)
        pr = cand.known_mask & jnp.asarray(ok)[:, :, None]
        best, bg, cov, st = rerank(
            docs, dmask, jq, jnp.asarray(gids),
            jnp.where(jnp.asarray(ok)[:, :, None], cand.a, 0.0),
            jnp.where(jnp.asarray(ok)[:, :, None], cand.b, 0.0),
            jax.random.split(key, B), pr, cand.known_vals)
        n_known = np.asarray(pr).sum((1, 2)).astype(np.float32)
        cards.append((np.asarray(best), np.asarray(bg)))
        revs.append(np.maximum(np.asarray(cov) * n_cells - n_known,
                               np.float32(0.0)))
        cells.append(n_cells)
        st = np.asarray(st)
        stats.append(np.concatenate([st[:3], [share[:, s].mean(),
                                              share[:, s].max()], st[3:]]
                                    ).astype(np.float32))
    tot_rev, tot_cells = revs[0], cells[0]
    for r, c in zip(revs[1:], cells[1:]):
        tot_rev, tot_cells = tot_rev + r, tot_cells + c
    best, ids = _np_merge(cards, K)
    return best, ids, tot_rev / np.maximum(tot_cells, np.float32(1.0)), \
        np.stack(stats)


@pytest.mark.parametrize("healthy", [None, (True, True, False, True)],
                         ids=["all-healthy", "shard-2-down"])
def test_mesh4_routed_step_equals_composed_jax_oracle(data, healthy):
    sc = shard_corpus(data["emb"], data["msk"], _mesh(4), n_centroids=4)
    hl = None if healthy is None else np.asarray(healthy)
    got = P.make_routed_serving_step(
        _mesh(4), "bandit", topk=K, n_local=8, n_total=20, kprime=6,
        prereveal_ann=True, alpha_ef=0.3, block_docs=4, block_tokens=4,
        base_seed=1, draws=REPLAY)(
        sc.embs, sc.mask, sc.router.centroids, sc.router.shard_mass,
        t(data["q"]), sc.valid_docs, 4, hl)
    want = _routed_oracle(data, sc, 8, 20, 6, 1, 4, hl)
    _same(got, want, str(healthy))
    if hl is not None:
        ids = got[1].numpy()
        assert not ((ids >= 22) & (ids < 33)).any()
        assert (got[3][2, 3:5] == 0).all()       # no quota to the dead shard


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("flavor", ["dense", "bandit"])
def test_routed_equals_host_routed_at_full_coverage(data, S, flavor):
    """JAX's parity setting: kprime >> C*L makes every doc a stage-1 hit
    with exact Eq. 15 bounds, host max_candidates >= C and local
    n_local >= c_loc with no quota; both stage 1s then emit ascending ids,
    so per-shard lists agree slot for slot and even the bandit's
    trajectories match bit for bit (shared seed contract)."""
    sc = shard_corpus(data["emb"], data["msk"], _mesh(S), n_centroids=4)
    n_local = 16 if S == 4 else 48
    q = t(data["q"])
    cand = candidates_for(t(data["emb"]), t(data["msk"]), q, kprime=KP,
                          max_candidates=48, support=(0.0, 1.0))
    cl, (a_l, b_l) = route_batch(cand.doc_ids.numpy(),
                                 [cand.a.numpy(), cand.b.numpy()],
                                 sc.docs_per_shard, S, n_local=n_local)
    kw = dict(topk=K, **_routed_kw(flavor))
    host = P.make_sharded_serving_step(_mesh(S), flavor, draws=REPLAY, **kw)(
        sc.embs, sc.mask, q, t(cl), t(a_l), t(b_l), sc.valid_docs, 0)
    routed = P.make_routed_serving_step(
        _mesh(S), flavor, n_local=n_local, n_total=0, kprime=KP,
        draws=REPLAY, **kw)(sc.embs, sc.mask, sc.router.centroids,
                            sc.router.shard_mass, q, sc.valid_docs, 0)
    assert torch.equal(routed[1], host[1])
    assert torch.equal(routed[0], host[0])
    assert torch.equal(routed[2], host[2])
    assert routed[3].shape == (S, 6) and (routed[3][:, 5] == 0).all()
    assert torch.equal(routed[3][:, :3], host[3][:, :3])
    if flavor == "dense":
        one = P.make_rerank_dense_step(_mesh(1), topk=K)(
            t(data["emb"]), t(data["msk"]), q, cand.doc_ids[:, None])
        for r in range(B):
            assert set(routed[1][r].tolist()) == set(one[1][r].tolist())


def test_routed_quota_capped_smoke(data):
    sc = shard_corpus(data["emb"], data["msk"], _mesh(4), n_centroids=4)
    s, i, f, st = P.make_routed_serving_step(
        _mesh(4), "bandit", topk=5, n_local=16, n_total=24, kprime=6,
        alpha_ef=0.3, block_docs=4, block_tokens=4, draws=REPLAY)(
        sc.embs, sc.mask, sc.router.centroids, sc.router.shard_mass,
        t(data["q"]), sc.valid_docs, 0)
    i, f, st = i.numpy(), f.numpy(), st.numpy()
    assert ((i >= -1) & (i < C)).all()
    for r in range(B):
        real = i[r][i[r] >= 0]
        assert len(set(real.tolist())) == len(real) >= 5
    assert ((f > 0.0) & (f <= 1.0 + 1e-6)).all()
    assert st.shape == (4, 6)
    assert np.isclose(st[:, 3].sum(), 1.0, atol=1e-4)
    assert (st[:, 4] >= st[:, 3] - 1e-6).all()


def test_routed_step_guards():
    with pytest.raises(ValueError, match="dense"):
        P.make_routed_serving_step(_mesh(4), corpus_format="int8")
    with pytest.raises(ValueError, match="prereveal_ann"):
        P.make_routed_serving_step(_mesh(4), prereveal_ann=True,
                                   engine="vmapped")
    with pytest.raises(ValueError, match="global top-"):
        P.make_routed_serving_step(_mesh(4), topk=9, n_local=2)
    with pytest.raises(ValueError, match="flavor"):
        P.make_routed_serving_step(_mesh(4), "sparse")


# ---------------------------------------------------------------------------
# the engine's mesh paths
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ds():
    return make_retrieval_dataset(n_docs=47, n_queries=8, doc_len=16,
                                  min_doc_len=6, query_len=8, dim=16, seed=3)


def _cfg(**kw):
    base = dict(batch_size=4, deadline_s=0.5, token_buckets=(8,),
                cand_buckets=(16,), max_k=5, flavor="dense",
                stage1_candidates=16, stage1_kprime=4)
    base.update(kw)
    return EngineConfig(**base)


def _requests(ds, n=8, with_cands=True):
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        n_tok = int(rng.integers(2, 9))
        cand = (rng.choice(47, int(rng.integers(5, 17)), replace=False)
                if with_cands and i % 2 else None)
        out.append((ds.queries[i][:n_tok], cand))
    return out


def _jax_mesh_engine(ds, cfg):
    """The JAX engine on a one-device mesh. Its host stage-1 executable
    over the mesh-resident corpus does not compile on this JAX version (a
    ShardingTypeError in the gather, the failure behind the reference's
    red sharded-engine tests), so its cache is seeded with the same stage
    1, JAX's ``generate_candidates`` vmapped over the queries, on the same
    one-shard corpus as plain arrays. Every other bucket is the JAX
    engine's own."""
    jeng = JRetrievalEngine(ds.doc_embs, ds.doc_mask,
                            JEngineConfig(**dataclasses.asdict(cfg)))
    embs = jnp.asarray(np.asarray(jeng.corpus_embs))
    mask = jnp.asarray(np.asarray(jeng.corpus_mask))

    @jax.jit
    def stage1(ce, cm, q):
        def one(qq):
            cs = j_generate(embs, mask, qq, kprime=cfg.stage1_kprime,
                            max_candidates=jeng._stage1_n,
                            support=cfg.support)
            return cs.doc_ids, cs.a, cs.b
        return jax.vmap(one)(q)

    for tb in cfg.token_buckets:
        jeng._exec[("stage1", tb)] = stage1
    return jeng


@pytest.mark.parametrize("setting", [
    dict(flavor="dense"),
    dict(flavor="bandit", seed=4, **HARD),
    dict(flavor="dense", stage1="local", stage1_total=12),
    dict(flavor="bandit", stage1="local", stage1_kprime=KP,
         stage1_candidates=16, prereveal_ann=True),
], ids=["dense", "bandit", "local-dense-quota", "local-bandit"])
def test_mesh1_engine_equals_jax_engine(ds, setting):
    """The engine at mesh_axes=(("data", 1),) against the JAX engine on a
    one-device mesh, in-process: every completion's ids, reveal fraction
    and coverage exact, scores to RTOL/ATOL, and each batch's per-shard
    stats; zero rebuilds after warmup."""
    cfg = _cfg(mesh_axes=(("data", 1),), **setting)
    eng = RetrievalEngine(ds.doc_embs, ds.doc_mask, cfg, device="cpu",
                          draws=REPLAY)
    jeng = _jax_mesh_engine(ds, cfg)
    assert eng.warmup() == jeng.warmup()
    local = setting.get("stage1") == "local"
    for query, cand in _requests(ds, with_cands=not local):
        eng.submit(Request(query=query, k=5, cand_ids=cand))
        jeng.submit(JRequest(query=query, k=5, cand_ids=cand))
    got = {c.rid: c for c in eng.drain()}
    want = {c.rid: c for c in jeng.drain()}
    assert sorted(got) == sorted(want) == list(range(8))
    for rid, c in got.items():
        w = want[rid]
        np.testing.assert_array_equal(c.topk_ids, w.topk_ids)
        np.testing.assert_allclose(c.topk_scores, w.topk_scores, rtol=RTOL,
                                   atol=ATOL)
        assert c.reveal_fraction == w.reveal_fraction
        assert (c.flavor, c.bucket, c.coverage) == (w.flavor, w.bucket,
                                                    w.coverage)
    for b, w in zip(eng.metrics.batches, jeng.metrics.batches):
        assert (b.shard_rounds, b.shard_occupancy, b.shard_quota_share,
                b.total_rounds, b.quarantined) == (
            w.shard_rounds, w.shard_occupancy, w.shard_quota_share,
            w.total_rounds, w.quarantined)
    assert eng.metrics.compiles_after_warmup == 0
    s, js = eng.metrics.summary(), jeng.metrics.summary()
    for key in ("n_shards", "shard_rounds_total", "routed_quota_share_mean",
                "routed_skew", "shard_healthy", "failovers"):
        assert s.get(key) == js.get(key), key


def _mesh4_cfg(**kw):
    return _cfg(mesh_axes=(("data", 2), ("model", 2)), **kw)


def test_mesh4_engine_equals_single_device_engine(ds):
    """JAX's sharded-engine claim: a mixed stream (provided and stage-1
    candidates) on a (2, 2) mesh returns the single-device engine's top-K
    sets, with zero rebuilds and per-shard metrics."""
    eng = RetrievalEngine(ds.doc_embs, ds.doc_mask, _mesh4_cfg(),
                          device="cpu")
    solo = RetrievalEngine(ds.doc_embs, ds.doc_mask, _cfg(), device="cpu")
    assert eng.warmup() == solo.warmup()
    for query, cand in _requests(ds):
        for e in (eng, solo):
            e.submit(Request(query=query, k=5, cand_ids=cand))
    got = {c.rid: c for c in eng.drain()}
    want = {c.rid: c for c in solo.drain()}
    for rid, c in got.items():
        assert set(c.topk_ids) == set(want[rid].topk_ids)
        np.testing.assert_allclose(np.sort(c.topk_scores),
                                   np.sort(want[rid].topk_scores),
                                   rtol=RTOL, atol=ATOL)
    assert eng.metrics.compiles_after_warmup == 0
    s = eng.metrics.summary()
    assert s["n_shards"] == 4 and len(s["shard_occupancy_mean"]) == 4
    assert eng.sharded is eng.corpus and solo.sharded is None


def test_mesh4_engine_failover_and_restore(ds):
    """After fail_shard(1) no completion holds a doc of shard 1 (rows
    12..23), coverage reports the healthy share, nothing is rebuilt; after
    restore_shard(1) the healthy results come back bit for bit."""
    cfg = _mesh4_cfg(flavor="bandit", seed=2, alpha_ef=0.3, block_docs=4,
                     block_tokens=4)
    eng = RetrievalEngine(ds.doc_embs, ds.doc_mask, cfg, device="cpu",
                          draws=REPLAY)
    eng.warmup()
    reqs = [(q, np.arange(16) * 3 % 47) for q, _ in _requests(ds, 4)]

    def serve():
        for q, cand in reqs:
            eng.submit(Request(query=q, k=5, cand_ids=cand))
        return sorted(eng.drain(), key=lambda c: c.rid)

    before = serve()
    eng.fail_shard(1)
    assert eng.shard_health().tolist() == [True, False, True, True]
    down = serve()
    for c in down:
        assert not ((c.topk_ids >= 12) & (c.topk_ids < 24)).any()
        assert c.coverage == pytest.approx(12 / 16)
    eng.restore_shard(1)
    after = serve()
    s = eng.metrics.summary()
    assert s["failovers"] == 1 and s["shard_healthy"] == [True] * 4
    assert eng.metrics.compiles_after_warmup == 0
    # Batch ordinals advance, so compare with a fresh engine serving the
    # same batches with shard 1 down for the middle one.
    ref = RetrievalEngine(ds.doc_embs, ds.doc_mask, cfg, device="cpu",
                          draws=REPLAY)
    ref.warmup()
    for phase, want in ((None, before), (1, down), (None, after)):
        if phase is not None:
            ref.fail_shard(phase)
        for q, cand in reqs:
            ref.submit(Request(query=q, k=5, cand_ids=cand))
        got = sorted(ref.drain(), key=lambda c: c.rid)
        for g, w in zip(got, want):
            assert np.array_equal(g.topk_ids, w.topk_ids)
            assert np.array_equal(g.topk_scores, w.topk_scores)
        if phase is not None:
            ref.restore_shard(phase)
    with pytest.raises(ValueError, match="out of range"):
        eng.fail_shard(4)


@pytest.mark.parametrize("stage1", ["host", "local"])
def test_chaos_shard_down_and_up(ds, stage1):
    """The chaos plan flips shard health from the dispatch thread: no
    request is lost or duplicated, batches served while shard 0 is down
    hold none of its docs (rows 0..11), and nothing is rebuilt."""
    plan = FaultPlan([InjectedFault("dispatch", 2, "shard_down", 0),
                      InjectedFault("dispatch", 4, "shard_up", 0)])
    cfg = _mesh4_cfg(batch_size=2, deadline_s=30.0, stage1=stage1,
                     stage1_total=12 if stage1 == "local" else 0,
                     pipeline_depth=1)
    eng = AsyncRetrievalEngine(ds.doc_embs, ds.doc_mask, cfg, device="cpu",
                               fault_plan=plan)
    eng.warmup()
    reqs = [Request(query=ds.queries[i % 8][:8], k=5,
                    cand_ids=None if stage1 == "local" else
                    np.arange(16) * 3 % 47) for i in range(12)]
    with eng:
        for r in reqs:
            eng.submit(r)
        done = eng.drain()
    assert sorted(c.rid for c in done) == list(range(12))
    assert [f.action for f in plan.fired] == ["shard_down", "shard_up"]
    partial = [c for c in done if c.coverage < 1.0]
    assert partial
    for c in partial:
        assert not ((c.topk_ids >= 0) & (c.topk_ids < 12)).any()
    s = eng.metrics.summary()
    assert s["failovers"] == 1 and s["shard_healthy"] == [True] * 4
    assert eng.metrics.compiles_after_warmup == 0


def test_mesh_engine_guards(ds):
    with pytest.raises(ValueError, match="single-device"):
        RetrievalEngine(ds.doc_embs, ds.doc_mask,
                        _mesh4_cfg(flavor="bandit", continuous=True),
                        device="cpu").warmup()
    with pytest.raises(ValueError, match="mesh_axes"):
        RetrievalEngine(ds.doc_embs, ds.doc_mask, _cfg(stage1="local"),
                        device="cpu")
    eng = RetrievalEngine(ds.doc_embs, ds.doc_mask,
                          _mesh4_cfg(corpus_format="int8"), device="cpu")
    assert eng.corpus.n_shards == 4 and eng.corpus.fmt == "int8"
    eng.warmup()
    eng.submit(Request(query=ds.queries[0][:8], k=5,
                       cand_ids=np.arange(10)))
    (c,) = eng.drain()
    assert (c.topk_ids >= 0).all()
