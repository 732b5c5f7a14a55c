"""The port's bandit core against the JAX package, on the CPU: bounds, tie
order, LUCB block selection, the chain body's reveal update and the pooled
engine on the oracle H matrix with JAX's own random draws replayed.

Decisions (indices, masks, rounds, trips) must match exactly; float
statistics match to rtol=1e-5 because the two frameworks sum a row's
revealed values in different orders.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as jbatched
from repro.core import bounds as jbounds
from repro.core.frontier import run_pooled_oracle as j_run_pooled_oracle
from repro.core.state import init_state as j_init_state
from repro.data import synthetic as jsynthetic
from repro_torch.core import bounds as tbounds
from repro_torch.core.bandit import stable_topk
from repro_torch.core.batched import _apply_block_reveal, _round_select
from repro_torch.core.frontier import run_pooled_oracle
from repro_torch.core.state import BanditState
from repro_torch.data import synthetic as tsynthetic


def key_data(keys) -> torch.Tensor:
    """JAX keys -> their data words as an int64 tensor (a seed or draw
    state of :class:`JaxReplayDraws`)."""
    return torch.from_numpy(
        np.asarray(jax.random.key_data(keys)).astype(np.int64))


def _wrap(t: torch.Tensor):
    return jax.random.wrap_key_data(
        jnp.asarray(t.cpu().numpy().astype(np.uint32)))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_init(keys, N, T):
    state, k_init = jax.vmap(lambda k: tuple(jax.random.split(k)))(keys)
    t0 = jax.vmap(lambda k: jax.random.randint(k, (N,), 0, T))(k_init)
    return jax.random.key_data(state), t0


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_round(state, W, T):
    def one(k):
        k2, k_eps, k_tok = jax.random.split(k, 3)
        return (jax.random.key_data(k2), jax.random.uniform(k_eps, (W, 1)),
                jax.random.gumbel(k_tok, (W, T)))
    return jax.vmap(one)(state)


class JaxReplayDraws:
    """A ``DrawSource`` that replays the JAX package's key chain. Seeds and
    draw states are JAX keys' data words (``key_data``). Per slot
    ``state, k_init = split(key)`` and ``randint(k_init)`` for the init
    reveal, masked to fresh slots as ``where(fresh, split(keys)[0],
    carry.key)``; every trip ``state, k_eps, k_tok = split(state, 3)`` with
    ``uniform(k_eps, (W, 1))`` and ``gumbel(k_tok, (W, T))``; Algorithm 1's
    ``split(key, 3)`` start; ``uniform(key, shape)`` for Doc-Uniform;
    ``fold_in`` / ``split`` of one key for the serving engine's batch and
    stream-slot keys."""

    def key(self, seed, device="cuda"):
        return key_data(jax.random.key(seed)).to(device)

    def keys(self, seed, n, device="cuda"):
        return key_data(jax.random.split(jax.random.key(seed), n)).to(device)

    def fold_in(self, seed, data):
        return key_data(jax.random.fold_in(_wrap(seed), data)).to(
            seed.device)

    def split(self, seed, n):
        return key_data(jax.random.split(_wrap(seed), n)).to(seed.device)

    def init(self, seeds, fresh, state, N, T):
        new, t0 = _jax_init(_wrap(seeds), N, T)
        new, t0 = _t(new).long(), _t(t0).long()
        if state is not None and fresh is not None:
            new = torch.where(fresh.cpu()[:, None], new, state.cpu())
        return new.to(seeds.device), t0.to(seeds.device)

    def round(self, state, W, T):
        new, u, g = _jax_round(_wrap(state), W, T)
        return (_t(new).long().to(state.device), _t(u).to(state.device),
                _t(g).to(state.device))

    def init_alg1(self, seed, N, T, n_warm):
        key, k_init, k_warm = jax.random.split(_wrap(seed), 3)
        t0 = jax.random.randint(k_init, (N,), 0, T)
        warm = jax.random.permutation(k_warm, N * T)[:n_warm]
        return (key_data(key)[None].to(seed.device),
                _t(t0).long().to(seed.device),
                _t(warm).long().to(seed.device))

    def uniform(self, seed, shape):
        return _t(jax.random.uniform(_wrap(seed), tuple(shape))).to(
            seed.device)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# (b) bounds
# ---------------------------------------------------------------------------

def _stats_case(seed, N=24, T=16):
    """Rows with n in {0, 1, T/2, T} revealed cells, values in [0, 1]."""
    rng = np.random.default_rng(seed)
    n_rows = np.array([0, 1, T // 2, T] * (N // 4))
    revealed = np.zeros((N, T), bool)
    for i, n in enumerate(n_rows):
        revealed[i, rng.choice(T, n, replace=False)] = True
    vals = rng.uniform(0.0, 1.0, (N, T)).astype(np.float32)
    vals = np.where(revealed, vals, 0.0).astype(np.float32)
    a = np.zeros((N, T), np.float32)
    b = rng.uniform(0.5, 1.0, (N, T)).astype(np.float32)
    return (revealed.sum(-1).astype(np.int32), vals.sum(-1),
            (vals * vals).sum(-1), revealed, a, b)


@pytest.mark.parametrize("bias_kappa", [0.0, 0.25])
def test_bounds_match_jax_at_n_0_1_half_full(bias_kappa):
    n, total, total_sq, revealed, a, b = _stats_case(0)
    T, N = revealed.shape[1], 256
    kw = dict(T=T, N=N, delta=0.01, alpha_ef=0.3, c=1.0,
              bias_kappa=bias_kappa)
    jiv = jbounds.intervals(jnp.asarray(n), jnp.asarray(total),
                            jnp.asarray(total_sq), jnp.asarray(revealed),
                            jnp.asarray(a), jnp.asarray(b), **kw)
    tiv = tbounds.intervals(_t(n), _t(total), _t(total_sq), _t(revealed),
                            _t(a), _t(b), **kw)
    for field in jiv._fields:
        np.testing.assert_allclose(getattr(tiv, field).numpy(),
                                   np.asarray(getattr(jiv, field)),
                                   rtol=1e-6, err_msg=field)
    np.testing.assert_allclose(tbounds.rho_n(_t(n), T).numpy(),
                               np.asarray(jbounds.rho_n(jnp.asarray(n), T)),
                               rtol=1e-6)
    assert np.isinf(tiv.radius.numpy()[n <= 1]).all()
    if bias_kappa == 0.0:     # rho_n(T) = 0; the range term stays
        assert (tiv.radius.numpy()[n == T] == 0).all()


# ---------------------------------------------------------------------------
# (c) tie order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 5, 40])
def test_stable_topk_breaks_ties_like_lax_top_k(k):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 4, (5, 40)).astype(np.float32)
    x[:, ::7] = np.float32(-3e38)
    x[1] = -2.5                       # a row that is one tie
    x[2, :5] = np.array([np.inf, -np.inf, 0.5, 3e38, -1e-30], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = stable_topk(_t(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# ---------------------------------------------------------------------------
# (d) LUCB block selection and the chain body's reveal update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("epsilon,G", [(0.1, 4), (0.6, 8)])
def test_round_select_matches_jax_on_the_same_draws(epsilon, G):
    Q, N, T, k, half = 3, 24, 16, 5, 4
    W = 2 * half
    keys = jax.random.split(jax.random.key(7), Q)
    per_q, draws = [], []
    for q in range(Q):
        n, total, total_sq, revealed, a, _ = _stats_case(10 + q, N, T)
        # a generic (0, 1)-style support with few distinct widths: ties
        b = np.random.default_rng(q).choice(
            np.float32([0.5, 0.8, 1.0]), (N, T))
        mask = np.ones(N, bool)
        mask[[5, 17]] = False
        jiv = jbounds.intervals(jnp.asarray(n), jnp.asarray(total),
                                jnp.asarray(total_sq), jnp.asarray(revealed),
                                jnp.asarray(a), jnp.asarray(b), T=T, N=N,
                                delta=0.01, alpha_ef=0.3)
        jm = jnp.asarray(mask)
        jiv = jiv._replace(s_hat=jnp.where(jm, jiv.s_hat, -3e38),
                           lcb=jnp.where(jm, jiv.lcb, -3e38),
                           ucb=jnp.where(jm, jiv.ucb, -3e38))
        sel = jbatched._round_select(keys[q], jiv, jnp.asarray(revealed),
                                     jnp.asarray(n), jnp.asarray(a),
                                     jnp.asarray(b), jm, k=k,
                                     epsilon=epsilon, half=half, G=G)
        _, k_eps, k_tok = jax.random.split(keys[q], 3)
        draws.append((np.asarray(jax.random.uniform(k_eps, (W, 1))),
                      np.asarray(jax.random.gumbel(k_tok, (W, T)))))
        per_q.append((jiv, revealed, n, a, b, mask, sel))

    def stack(i, field=None):
        return _t(np.stack([np.asarray(getattr(p[i], field) if field
                                       else p[i]) for p in per_q]))

    tiv = tbounds.Intervals(*(stack(0, f) for f in tbounds.Intervals._fields))
    got = _round_select(_t(np.stack([d[0] for d in draws])),
                        _t(np.stack([d[1] for d in draws])), tiv, stack(1),
                        stack(2), stack(3), stack(4), stack(5), k=k,
                        epsilon=epsilon, half=half, G=G)
    for q in range(Q):
        sel = per_q[q][6]
        np.testing.assert_array_equal(got.doc_idx[q], np.asarray(sel.doc_idx))
        np.testing.assert_array_equal(got.tok_idx[q], np.asarray(sel.tok_idx))
        np.testing.assert_array_equal(got.cell_ok[q], np.asarray(sel.cell_ok))
        assert bool(got.stop[q]) == bool(sel.stop)


def test_apply_block_reveal_matches_jax():
    rng = np.random.default_rng(3)
    R, T, S, G = 20, 12, 9, 5
    n, total, total_sq, revealed, _, _ = _stats_case(4, R, T)
    values = np.where(revealed, rng.uniform(0, 1, (R, T)), 0).astype(
        np.float32)
    doc_idx = rng.integers(0, R, S)
    doc_idx[[1, 4]] = doc_idx[0]                 # duplicate rows
    tok_idx = np.stack([rng.choice(T, G, replace=False) for _ in range(S)])
    vals = rng.uniform(0, 1, (S, G)).astype(np.float32)
    valid = rng.random((S, G)) < 0.7
    valid[1] = False                             # a dead duplicate slot
    js = j_init_state(R, T, jax.random.key(0))._replace(
        values=jnp.asarray(values), revealed=jnp.asarray(revealed),
        n=jnp.asarray(n), total=jnp.asarray(total),
        total_sq=jnp.asarray(total_sq))
    want = jbatched._apply_block_reveal(
        js, jnp.asarray(doc_idx, jnp.int32), jnp.asarray(tok_idx, jnp.int32),
        jnp.asarray(vals), jnp.asarray(valid))
    ts = BanditState(values=_t(values), revealed=_t(revealed),
                     n=_t(n).long(), total=_t(total), total_sq=_t(total_sq),
                     rounds=torch.zeros(1, dtype=torch.int64),
                     done=torch.zeros(1, dtype=torch.bool))
    got = _apply_block_reveal(ts, _t(doc_idx), _t(tok_idx), _t(vals),
                              _t(valid))
    np.testing.assert_array_equal(got.values, np.asarray(want.values))
    np.testing.assert_array_equal(got.revealed, np.asarray(want.revealed))
    np.testing.assert_array_equal(got.n, np.asarray(want.n))
    np.testing.assert_allclose(got.total, np.asarray(want.total), rtol=1e-6)
    np.testing.assert_allclose(got.total_sq, np.asarray(want.total_sq),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# (e) the pooled engine on the oracle H, both round bodies
# ---------------------------------------------------------------------------

def test_synthetic_copy_is_verbatim():
    for f in ("make_mixed_difficulty_h",):
        np.testing.assert_array_equal(
            getattr(tsynthetic, f)(3, 10, 8, k=3, seed=2),
            getattr(jsynthetic, f)(3, 10, 8, k=3, seed=2))
    kw = dict(n_docs=30, n_queries=3, doc_len=12, min_doc_len=3,
              query_len=6, dim=8, seed=5)
    jd, td = (jsynthetic.make_retrieval_dataset(**kw),
              tsynthetic.make_retrieval_dataset(**kw))
    for f in ("doc_embs", "doc_mask", "doc_lens", "queries", "qrels"):
        np.testing.assert_array_equal(getattr(td, f), getattr(jd, f))


ORACLE_CASES = {
    "seed0": dict(seed=0, hard=1, masked=False, cfg={}),
    "seed1-masked": dict(seed=1, hard=2, masked=True, cfg={}),
    "growth": dict(seed=2, hard=2, masked=False,
                   cfg=dict(max_block_docs=16, max_block_tokens=8)),
}


def _oracle_inputs(case):
    Q, N, T = 4, 32, 16
    H = jsynthetic.make_mixed_difficulty_h(Q, N, T, k=5,
                                           hard_frac=case["hard"] / Q,
                                           seed=case["seed"])
    a, b = np.zeros(H.shape, np.float32), np.ones(H.shape, np.float32)
    mask = np.ones((Q, N), bool)
    if case["masked"]:
        mask[:, -5:] = False
        mask[2, :3] = False
    keys = jax.random.split(jax.random.key(case["seed"]), Q)
    kw = dict(k=5, alpha_ef=0.3, block_docs=8, block_tokens=4, **case["cfg"])
    return H, a, b, mask, keys, kw


@pytest.fixture(scope="module")
def jax_oracle_runs():
    out = {}
    for name, case in ORACLE_CASES.items():
        H, a, b, mask, keys, kw = _oracle_inputs(case)
        for fused in (True, False):
            out[name, fused] = j_run_pooled_oracle(
                jnp.asarray(H), jnp.asarray(a), jnp.asarray(b), keys,
                fused=fused, doc_mask=jnp.asarray(mask), **kw)
    return out


def _port_oracle(case, fused):
    H, a, b, mask, keys, kw = _oracle_inputs(case)
    return run_pooled_oracle(_t(H), _t(a), _t(b), key_data(keys),
                             draws=JaxReplayDraws(), fused=fused,
                             doc_mask=_t(mask), **kw)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "chain"])
@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_pooled_oracle_matches_jax_with_replayed_draws(jax_oracle_runs, case,
                                                       fused):
    want = jax_oracle_runs[case, fused]
    got = _port_oracle(ORACLE_CASES[case], fused)
    for field in ("topk", "reveals", "rounds", "trips", "revealed",
                  "separated", "total_rounds", "lockstep_waste",
                  "quarantined"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    np.testing.assert_allclose(got.s_hat.numpy(), np.asarray(want.s_hat),
                               rtol=1e-5)
    np.testing.assert_allclose(got.coverage.numpy(),
                               np.asarray(want.coverage), rtol=1e-6)
    np.testing.assert_allclose(float(got.occupancy), float(want.occupancy),
                               rtol=1e-6)


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_pooled_oracle_chain_is_bit_identical_to_fused(case):
    chain = _port_oracle(ORACLE_CASES[case], fused=False)
    fused = _port_oracle(ORACLE_CASES[case], fused=True)
    for field in chain._fields:
        np.testing.assert_array_equal(getattr(chain, field).numpy(),
                                      getattr(fused, field).numpy(),
                                      err_msg=field)
