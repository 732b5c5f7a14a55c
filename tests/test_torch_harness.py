"""The paper's research harness, the port against the JAX package on the
CPU: the state helpers, Algorithm 1 (``run_bandit``), the solo block
bandit (``run_batched_bandit`` / ``run_batched_oracle``), the baselines,
the task metrics, and ``rerank_query`` / ``evaluate_dataset`` for every
method.

The port replays JAX's keys (``JaxReplayDraws``: ``split(key, 3)`` for
Algorithm 1, ``split(key)`` for the block bandit, ``uniform(key)`` for
Doc-Uniform). JAX's pipeline runs its plain lane (``REPRO_KERNEL_IMPL=
ref``). Ids, masks, rounds and reveal counts must match exactly; scores,
statistics, coverage and FLOPs to rtol=1e-5, because the frameworks sum
rows in different orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import BanditConfig as JBanditConfig
from repro.core import baselines as jbaselines
from repro.core import metrics as jmetrics
from repro.core import state as jstate
from repro.core.bandit import run_bandit as j_run_bandit
from repro.core.batched import run_batched_oracle as j_batched_oracle
from repro.data.synthetic import make_mixed_difficulty_h
from repro.data.synthetic import make_retrieval_dataset
from repro.retrieval import pipeline as jpipeline
from repro.retrieval.index import build_index as j_build_index
from repro_torch.configs.base import BanditConfig
from repro_torch.core import baselines, metrics, state
from repro_torch.core.bandit import run_bandit
from repro_torch.core.batched import run_batched_oracle
from repro_torch.core.draws import TorchDraws
from repro_torch.retrieval import pipeline
from repro_torch.retrieval.index import from_numpy
from test_torch_core import JaxReplayDraws, key_data
from test_torch_threads import cap_torch_threads

cap_torch_threads()

REPLAY = JaxReplayDraws()
RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _oracle(seed, N=32, T=12):
    H = make_mixed_difficulty_h(1, N, T, k=5, hard_frac=1.0, seed=seed)[0]
    rng = np.random.default_rng(seed)
    mask = np.ones(N, bool)
    mask[rng.choice(N, 3, replace=False)] = False
    b = np.clip(H + rng.uniform(0.0, 0.3, H.shape), 0, 1).astype(np.float32)
    return H, np.zeros_like(H), b, mask


def _assert_bandit_equal(got, want):
    for f in ("topk", "reveals", "rounds", "separated", "revealed"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.s_hat, np.asarray(want.s_hat), rtol=RTOL)
    np.testing.assert_allclose(float(got.coverage), float(want.coverage),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# state helpers
# ---------------------------------------------------------------------------

def test_state_helpers_match_jax():
    H, _, _, mask = _oracle(1)
    N, T = H.shape
    rng = np.random.default_rng(1)
    m1, m2 = rng.random((N, T)) < 0.2, rng.random((N, T)) < 0.3
    js = jstate.init_state(N, T, jax.random.key(0))
    ts = state.init_state(N, T, torch.zeros((1, 2), dtype=torch.int64))
    js = jstate.reveal_mask(js, jnp.asarray(H), jnp.asarray(m1))
    ts = state.reveal_mask(ts, _t(H), _t(m1))
    for i, t in [(0, 0), (3, 5), (0, 0), (N - 1, T - 1)]:   # one repeat
        js = jstate.reveal_cell(js, jnp.asarray(H), i, t)
        ts = state.reveal_cell(ts, _t(H), torch.tensor(i), torch.tensor(t))
    js = jstate.reveal_mask(js, jnp.asarray(H), jnp.asarray(m2))
    ts = state.reveal_mask(ts, _t(H), _t(m2))
    for f in ("values", "revealed", "n"):
        np.testing.assert_array_equal(getattr(ts, f),
                                      np.asarray(getattr(js, f)), err_msg=f)
    for f in ("total", "total_sq"):
        np.testing.assert_allclose(getattr(ts, f), np.asarray(getattr(js, f)),
                                   rtol=RTOL, err_msg=f)
    for dm in (None, mask):
        np.testing.assert_allclose(
            float(state.coverage(ts, None if dm is None else _t(dm))),
            float(jstate.coverage(js, None if dm is None else
                                  jnp.asarray(dm))), rtol=1e-6)


# ---------------------------------------------------------------------------
# Algorithm 1 and the solo block bandit
# ---------------------------------------------------------------------------

ALG1_CASES = {
    "default": dict(),
    "masked": dict(masked=True),
    "warmup": dict(masked=True, warmup_fraction=0.1),
    "prereveal": dict(masked=True, prereveal=True, init_one_per_doc=False),
    "budget": dict(max_reveals=60),
    "explore": dict(epsilon=0.5, bias_kappa=0.25),
}


@pytest.mark.parametrize("case", list(ALG1_CASES))
def test_run_bandit_matches_jax(case):
    kw = dict(ALG1_CASES[case])
    H, a, b, mask = _oracle(2)
    key = jax.random.key(2)
    j_kw, t_kw = {}, {}
    if kw.pop("masked", False):
        j_kw["doc_mask"], t_kw["doc_mask"] = jnp.asarray(mask), _t(mask)
    if kw.pop("prereveal", False):
        pr = np.random.default_rng(2).random(H.shape) < 0.15
        j_kw["prereveal"], t_kw["prereveal"] = jnp.asarray(pr), _t(pr)
    want = j_run_bandit(jnp.asarray(H), jnp.asarray(a), jnp.asarray(b), key,
                        k=5, **kw, **j_kw)
    got = run_bandit(_t(H), _t(a), _t(b), key_data(key), k=5, draws=REPLAY,
                     **kw, **t_kw)
    _assert_bandit_equal(got, want)
    if case == "budget":
        assert int(got.reveals) <= 60 + H.shape[0]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bd,g", [(8, 4), (4, 8)])
def test_run_batched_oracle_matches_jax(bd, g, masked):
    H, a, b, mask = _oracle(3)
    key = jax.random.key(3)
    dm = mask if masked else np.ones_like(mask)
    want = j_batched_oracle(jnp.asarray(H), jnp.asarray(a), jnp.asarray(b),
                            key, k=5, block_docs=bd, block_tokens=g,
                            doc_mask=jnp.asarray(dm))
    got = run_batched_oracle(_t(H), _t(a), _t(b), key_data(key), k=5,
                             block_docs=bd, block_tokens=g, doc_mask=_t(dm),
                             draws=REPLAY)
    _assert_bandit_equal(got, want)


def test_solo_bandits_run_on_torch_draws():
    H, a, b, mask = _oracle(4)
    seed = TorchDraws().key(4, "cpu")
    for run in (run_bandit, run_batched_oracle):
        one = run(_t(H), _t(a), _t(b), seed, k=5, doc_mask=_t(mask))
        two = run(_t(H), _t(a), _t(b), seed, k=5, doc_mask=_t(mask))
        assert torch.equal(one.revealed, two.revealed)
        assert float(one.coverage) < 1.0


# ---------------------------------------------------------------------------
# baselines and metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget", [1, 3, 12])
def test_baselines_match_jax(budget):
    H, a, b, mask = _oracle(5)
    # few distinct widths, so Doc-TopMargin's rank order has ties
    b = np.round(b * 4) / 4
    key = jax.random.key(5)
    want = jbaselines.doc_uniform(jnp.asarray(H), key, k=5, budget=budget,
                                  doc_mask=jnp.asarray(mask))
    got = baselines.doc_uniform(_t(H), key_data(key), k=5, budget=budget,
                                doc_mask=_t(mask), draws=REPLAY)
    want_m = jbaselines.doc_top_margin(jnp.asarray(H), jnp.asarray(a),
                                       jnp.asarray(b), k=5, budget=budget,
                                       doc_mask=jnp.asarray(mask))
    got_m = baselines.doc_top_margin(_t(H), _t(a), _t(b), k=5,
                                     budget=budget, doc_mask=_t(mask))
    for g, w in ((got, want), (got_m, want_m)):
        np.testing.assert_array_equal(g.topk, np.asarray(w.topk))
        np.testing.assert_array_equal(g.revealed, np.asarray(w.revealed))
        np.testing.assert_allclose(g.scores, np.asarray(w.scores), rtol=RTOL)
        np.testing.assert_allclose(float(g.coverage), float(w.coverage),
                                   rtol=1e-6)
    for dm in (None, mask):
        wi, ws = jbaselines.exact_topk(
            jnp.asarray(H), k=5, doc_mask=None if dm is None
            else jnp.asarray(dm))
        gi, gs = baselines.exact_topk(_t(H), k=5,
                                      doc_mask=None if dm is None else _t(dm))
        np.testing.assert_array_equal(gi, np.asarray(wi))
        np.testing.assert_allclose(gs, np.asarray(ws), rtol=RTOL)


@pytest.mark.parametrize("seed", range(4))
def test_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    N, K = 20, 5
    topk = rng.choice(N, K, replace=False)
    star = rng.choice(N, K, replace=False)
    relevant = rng.random(N) < [0.0, 0.1, 0.3, 0.6][seed]
    want = jmetrics.all_metrics(jnp.asarray(topk), jnp.asarray(star),
                                jnp.asarray(relevant))
    got = metrics.all_metrics(_t(topk), _t(star), _t(relevant))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# rerank_query / evaluate_dataset
# ---------------------------------------------------------------------------

METHODS = {"exact": {}, "bandit": {}, "bandit-prereveal":
           dict(prereveal_ann=True), "batched": {}, "uniform": {},
           "topmargin": {}, "bandit-no-ann": dict(use_ann_bounds=False)}
HARNESS = dict(k=5, kprime=8, max_candidates=24)


def _dataset(seed=6):
    return make_retrieval_dataset(n_docs=40, n_queries=3, doc_len=16,
                                  min_doc_len=4, query_len=8, dim=16,
                                  seed=seed)


# ``use_kernel`` picks JAX's H: its reference (``maxsim_ref``) or its kernel
# lane (``maxsim_op``, L-chunked under REPRO_KERNEL_IMPL=ref). The port takes
# the flag and computes H with ``maxsim_op`` either way.
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel"])
@pytest.mark.parametrize("name", list(METHODS))
def test_rerank_query_matches_jax(monkeypatch, name, use_kernel):
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "ref")
    ds = _dataset()
    kw = dict(METHODS[name], method=name.split("-")[0],
              use_kernel=use_kernel, **HARNESS)
    jidx = j_build_index(ds.doc_embs, ds.doc_mask, ds.doc_lens)
    tidx = from_numpy(ds.doc_embs, ds.doc_mask, ds.doc_lens, device="cpu")
    for qi in range(ds.n_queries):
        want = jpipeline.rerank_query(jidx, jnp.asarray(ds.queries[qi]),
                                      seed=qi, qrels_row=ds.qrels[qi],
                                      bandit=JBanditConfig(k=5), **kw)
        got = pipeline.rerank_query(tidx, ds.queries[qi], seed=qi,
                                    qrels_row=ds.qrels[qi], draws=REPLAY,
                                    bandit=BanditConfig(k=5), **kw)
        np.testing.assert_array_equal(got.topk_docs, want.topk_docs)
        assert (got.rounds, got.separated) == (want.rounds, want.separated)
        for f in ("coverage", "flops", "flops_exact", "overlap"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=RTOL, err_msg=f)
        assert got.metrics.keys() == want.metrics.keys()
        for m in want.metrics:
            np.testing.assert_allclose(got.metrics[m], want.metrics[m],
                                       rtol=1e-6, err_msg=m)
    if name == "exact":
        assert got.overlap == 1.0 and got.coverage == 1.0


def test_rerank_query_rejects_an_unknown_method():
    ds = _dataset()
    tidx = from_numpy(ds.doc_embs, ds.doc_mask, ds.doc_lens, device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        pipeline.rerank_query(tidx, ds.queries[0], method="oracle",
                              **HARNESS)


@pytest.mark.parametrize("method", ["bandit", "uniform", "exact"])
def test_evaluate_dataset_matches_jax(monkeypatch, method):
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "ref")
    ds = _dataset(7)
    want = jpipeline.evaluate_dataset(ds, method=method, **HARNESS)
    got = pipeline.evaluate_dataset(ds, method=method, device="cpu",
                                    draws=REPLAY, **HARNESS)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                   atol=1e-7, err_msg=name)
    # one query, on a prebuilt index
    idx = from_numpy(ds.doc_embs, ds.doc_mask, ds.doc_lens, device="cpu")
    first_only = dataclasses.replace(ds, queries=ds.queries[:1],
                                     qrels=ds.qrels[:1])
    one = pipeline.evaluate_dataset(first_only, method=method, index=idx,
                                    draws=REPLAY, **HARNESS)
    first = pipeline.rerank_query(idx, ds.queries[0], method=method, seed=0,
                                  qrels_row=ds.qrels[0], draws=REPLAY,
                                  **HARNESS)
    assert one["coverage"] == first.coverage


# ---------------------------------------------------------------------------
# examples/torch_calibration_sweep.py
# ---------------------------------------------------------------------------

def _example(name):
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_calibration_sweep_matches_jax(monkeypatch, capsys):
    """The example's alpha_ef sweep against ``benchmarks.common``'s
    ``frontier_bandit`` (what ``examples/calibration_sweep.py`` prints), on
    a small dataset, and its table at ``--device cpu``."""
    from benchmarks.common import bench_dataset as j_bench_dataset
    from benchmarks.common import frontier_bandit as j_frontier_bandit
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "ref")
    ex = _example("torch_calibration_sweep")
    ds = _dataset(7)
    alphas = (0.1, 0.8)
    want = j_frontier_bandit(ds, k=5, alphas=alphas)
    got = ex.frontier_bandit(ds, k=5, alphas=alphas, device="cpu",
                             draws=REPLAY)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for name in w:
            np.testing.assert_allclose(g[name], w[name], rtol=RTOL,
                                       atol=1e-7, err_msg=name)
    small = ex.bench_dataset(48, 2)
    ref = j_bench_dataset(48, 2)
    np.testing.assert_array_equal(small.doc_embs, ref.doc_embs)
    np.testing.assert_array_equal(small.queries, ref.queries)
    pts = ex.main(["--device", "cpu", "--n-docs", "48", "--n-queries", "2",
                   "--alphas", "0.2", "1.6"])
    out = capsys.readouterr().out
    assert out.startswith("alpha_ef   coverage   overlap@5   flops_saving")
    assert [p["alpha_ef"] for p in pts] == [0.2, 1.6]
    assert all(0 < p["coverage"] <= 1 for p in pts)
