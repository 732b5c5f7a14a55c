"""The pooled engine's streaming API against the JAX package, on the CPU:
``carry``/``fresh``/``trip_limit``/``return_state`` (``run_pooled_slice``,
``FrontierState``), the fidelity knobs ``alpha_scale``/``round_cap``, and
``prereveal``; plus the per-slot draws of ``TorchDraws``.

Mirrors ``tests/test_frontier.py``'s resumable-slice tests on the oracle H
of ``make_mixed_difficulty_h``, with JAX's key chain replayed per slot
(``JaxReplayDraws``). Decisions (ids, masks, rounds, trips, reveals, done
flags, draw states) must match exactly; float statistics to rtol=1e-5,
because the two frameworks sum a row's values in different orders. Within
the port, a resumed or refilled stream must equal the one-shot run bit for
bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.batched import BatchedConfig as JConfig
from repro.core.frontier import init_frontier_state as j_init_state
from repro.core.frontier import run_pooled_bandit as j_run
from repro.core.frontier import run_pooled_slice as j_slice
from repro.data.synthetic import make_mixed_difficulty_h
from repro_torch.core.batched import BatchedConfig
from repro_torch.core.draws import TorchDraws
from repro_torch.core.frontier import (_REV_THRESH, init_frontier_state,
                                       run_pooled_bandit, run_pooled_slice)
from test_torch_core import JaxReplayDraws, key_data
from test_torch_threads import cap_torch_threads

cap_torch_threads()

Q, N, T = 4, 40, 16
CFG_KW = dict(k=5, alpha_ef=0.3, block_docs=8, block_tokens=4)
CFG, J_CFG = BatchedConfig(**CFG_KW), JConfig(**CFG_KW)
REPLAY = JaxReplayDraws()
RTOL = 1e-5
DECISIONS = ("topk", "reveals", "rounds", "revealed", "separated", "trips",
             "total_rounds", "lockstep_waste", "quarantined")


def _case(seed):
    H = make_mixed_difficulty_h(Q, N, T, k=5, hard_frac=1 / Q, seed=seed)
    a, b = np.zeros(H.shape, np.float32), np.ones(H.shape, np.float32)
    return H, a, b, jax.random.split(jax.random.key(seed), Q)


def _j_cells(H):
    Qh, Nh, Th = H.shape
    h_flat = H.reshape(Qh * Nh, Th)

    def cells(flat_doc, flat_tok):
        t_local = flat_tok - (flat_doc // Nh * Th)[:, None]
        return h_flat[flat_doc[:, None], jnp.clip(t_local, 0, Th - 1)]

    return cells


def _t_cells(H):
    Qh, Nh, Th = H.shape
    h_flat = torch.as_tensor(H).reshape(Qh * Nh, Th)

    def cells(flat_doc, flat_tok):
        t_local = flat_tok - (flat_doc // Nh * Th)[:, None]
        return h_flat[flat_doc[:, None], torch.clamp(t_local, 0, Th - 1)]

    return cells


@functools.partial(jax.jit, static_argnames=("fused", "trip_limit"))
def _j_slice(H, a, b, keys, state, fresh, *, fused, trip_limit):
    return j_slice(_j_cells(H), a, b, keys, J_CFG, state, fresh,
                   trip_limit=trip_limit, fused=fused)


@functools.partial(jax.jit, static_argnames=("fused",))
def _j_knobs(H, a, b, keys, alpha_scale, round_cap, *, fused):
    return j_run(_j_cells(H), a, b, keys, J_CFG, fused=fused,
                 alpha_scale=alpha_scale, round_cap=round_cap)


@functools.partial(jax.jit, static_argnames=("fused",))
def _j_prereveal(H, a, b, keys, pr, pv, *, fused):
    return j_run(_j_cells(H), a, b, keys, J_CFG, fused=fused, prereveal=pr,
                 prereveal_vals=pv)


def _t(x):
    return torch.from_numpy(np.array(x))


def assert_result_equal(got, want, *, exact=True):
    """Port result against a port result (exact) or a JAX one (decisions
    exact, floats to RTOL)."""
    for f in DECISIONS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("s_hat", "coverage", "occupancy"):
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, err_msg=f)


def assert_state_matches_jax(got, want):
    np.testing.assert_array_equal(got.done, np.asarray(want.done))
    np.testing.assert_array_equal(got.rounds, np.asarray(want.rounds))
    np.testing.assert_array_equal(got.draw, key_data(want.key))
    np.testing.assert_array_equal(got.cellvals < _REV_THRESH,
                                  np.asarray(want.cellvals) < _REV_THRESH)
    np.testing.assert_allclose(got.cellvals, np.asarray(want.cellvals),
                               rtol=RTOL)
    np.testing.assert_allclose(got.stats, np.asarray(want.stats), rtol=RTOL)


# ---------------------------------------------------------------------------
# resume: pause every trip_limit trips, carry the state, resume
# ---------------------------------------------------------------------------

BODIES = {"fused": lambda i: True, "chain": lambda i: False,
          "alternate": lambda i: bool(i % 2)}


@pytest.fixture(scope="module")
def jax_resumes():
    """JAX's slice-by-slice runs (trip_limit=2) per body schedule: the
    (result, state) after every slice."""
    H, a, b, keys = _case(30)
    out = {}
    for name, body in BODIES.items():
        state, fresh, runs = j_init_state(Q, N, T), jnp.ones((Q,), bool), []
        for i in range(64):
            res, state = _j_slice(jnp.asarray(H), jnp.asarray(a),
                                  jnp.asarray(b), keys, state, fresh,
                                  fused=body(i), trip_limit=2)
            fresh = jnp.zeros((Q,), bool)
            runs.append((res, state))
            if bool(np.asarray(state.done).all()):
                break
        out[name] = runs
    return out


def _port_resume(H, a, b, seeds, body, draws):
    state = init_frontier_state(Q, N, T, device="cpu")
    fresh, runs = torch.ones((Q,), dtype=torch.bool), []
    for i in range(64):
        res, state = run_pooled_slice(_t_cells(H), _t(a), _t(b), seeds, CFG,
                                      state, fresh, trip_limit=2,
                                      fused=body(i), draws=draws)
        fresh = torch.zeros((Q,), dtype=torch.bool)
        runs.append((res, state))
        if bool(state.done.all()):
            return runs
    pytest.fail("stream never quiesced")


@pytest.mark.parametrize("body", list(BODIES))
def test_slice_resume_matches_one_shot_and_jax(jax_resumes, body):
    H, a, b, keys = _case(30)
    seeds = key_data(keys)
    runs = _port_resume(H, a, b, seeds, BODIES[body], REPLAY)
    want = jax_resumes[body]
    assert len(runs) == len(want)
    for (got_res, got_state), (want_res, want_state) in zip(runs, want):
        assert_result_equal(got_res, want_res, exact=False)
        assert_state_matches_jax(got_state, want_state)
    one_shot = run_pooled_bandit(_t_cells(H), _t(a), _t(b), seeds, CFG,
                                 fused=BODIES[body](0), draws=REPLAY)
    final = runs[-1][0]
    for f in ("topk", "s_hat", "reveals", "rounds", "revealed", "coverage",
              "separated"):
        np.testing.assert_array_equal(getattr(final, f),
                                      getattr(one_shot, f), err_msg=f)


# ---------------------------------------------------------------------------
# refill: 2 slots serve 4 queries
# ---------------------------------------------------------------------------

def _refill(H, a, b, seeds, order, S, slice_fn):
    """Serve the queries in ``order`` through S slots, refilling a retired
    slot with the next query; returns {query: (topk set, reveals, rounds,
    coverage)}. ``slice_fn(h, a, b, seeds, state, fresh)`` runs one slice
    on numpy slot inputs and returns numpy (topk, reveals, rounds,
    coverage, done) and the new state."""
    queue = list(order)
    slot_q = [queue.pop(0) for _ in range(S)]
    fresh = np.ones(S, bool)
    state, got = None, {}
    for _ in range(256):
        idx = np.asarray(slot_q)
        (topk, reveals, rounds, cov, done), state = slice_fn(
            H[idx], a[idx], b[idx], seeds[idx], state, fresh)
        fresh[:] = False
        for s in range(S):
            q = slot_q[s]
            if not done[s] or q in got:
                continue
            got[q] = (set(map(int, topk[s])), int(reveals[s]),
                      int(rounds[s]), float(cov[s]))
            if queue:
                slot_q[s] = queue.pop(0)
                fresh[s] = True
        if len(got) == len(order):
            return got
    pytest.fail("stream never served every query")


def _port_slice_fn(draws, fused=True):
    def run(h, a, b, seeds, state, fresh):
        if state is None:
            state = init_frontier_state(len(h), N, T, device="cpu")
        res, state = run_pooled_slice(_t_cells(h), _t(a), _t(b), seeds, CFG,
                                      state, _t(fresh), trip_limit=2,
                                      fused=fused, draws=draws)
        return tuple(x.numpy() for x in (res.topk, res.reveals, res.rounds,
                                         res.coverage, state.done)), state
    return run


def _jax_slice_fn(h, a, b, keys, state, fresh):
    if state is None:
        state = j_init_state(len(h), N, T)
    res, state = _j_slice(jnp.asarray(h), jnp.asarray(a), jnp.asarray(b),
                          keys, state, jnp.asarray(fresh), fused=True,
                          trip_limit=2)
    return tuple(np.asarray(x) for x in (res.topk, res.reveals, res.rounds,
                                         res.coverage, state.done)), state


def _one_shot_rows(H, a, b, seeds, draws):
    res = run_pooled_bandit(_t_cells(H), _t(a), _t(b), seeds, CFG,
                            draws=draws)
    return {q: (set(map(int, res.topk[q])), int(res.reveals[q]),
                int(res.rounds[q]), float(res.coverage[q]))
            for q in range(Q)}


def test_slice_refill_matches_one_shot_and_jax():
    """A 2-slot stream serving 4 queries gives every query the one-shot
    run's result, and JAX's run_pooled_slice stream gives the same."""
    H, a, b, keys = _case(32)
    seeds = key_data(keys)
    got = _refill(H, a, b, seeds, range(Q), 2, _port_slice_fn(REPLAY))
    assert got == _one_shot_rows(H, a, b, seeds, REPLAY)
    want = _refill(H, a, b, keys, range(Q), 2, _jax_slice_fn)
    for q in range(Q):
        assert got[q][:3] == want[q][:3], q
        np.testing.assert_allclose(got[q][3], want[q][3], rtol=1e-6)


@pytest.mark.parametrize("order,slots,fused", [
    ((0, 1, 2, 3), 2, True), ((3, 2, 1, 0), 2, False),
    ((2, 0, 3, 1), 3, True), ((1, 3, 0, 2), 1, True)])
def test_torch_draws_trajectory_independent_of_admission(order, slots,
                                                         fused):
    """Under the counter-based TorchDraws a query's result depends only on
    its own (inputs, seed): not on its slot, its admission trip, its
    slotmates or the round body."""
    H, a, b, _ = _case(33)
    draws = TorchDraws()
    seeds = draws.keys(33, Q, "cpu")
    got = _refill(H, a, b, seeds, order, slots,
                  _port_slice_fn(draws, fused=fused))
    assert got == _one_shot_rows(H, a, b, seeds, draws)


# ---------------------------------------------------------------------------
# TorchDraws itself
# ---------------------------------------------------------------------------

def test_torch_draws_are_per_slot_and_counter_based():
    draws = TorchDraws()
    seeds = draws.keys(7, 5, "cpu")
    assert seeds.dtype == torch.int64 and len(set(seeds.tolist())) == 5
    assert torch.equal(seeds, draws.keys(7, 5, "cpu"))
    assert not torch.equal(seeds, draws.keys(8, 5, "cpu"))
    state, t0 = draws.init(seeds, None, None, 12, 9)
    assert t0.shape == (5, 12) and int(t0.min()) >= 0 and int(t0.max()) < 9
    # Slot 3 alone, then among other slotmates at another position, and
    # admitted after its slotmates ran 4 trips: the same bits every trip.
    alone, _ = draws.init(seeds[3:4], None, None, 12, 9)
    later = state.clone()
    for _ in range(4):
        later, _, _ = draws.round(later, 6, 9)
    fresh = torch.tensor([False, True, False, False, False])
    mixed, _ = draws.init(seeds.flip(0), fresh, later, 12, 9)   # slot 1 <- 3
    for _ in range(3):
        alone, u1, g1 = draws.round(alone, 6, 9)
        mixed, u2, g2 = draws.round(mixed, 6, 9)
        assert torch.equal(u1[0], u2[1]) and torch.equal(g1[0], g2[1])
        assert torch.equal(alone[0], mixed[1])
    assert ((u1 > 0) & (u1 < 1)).all() and torch.isfinite(g1).all()
    # Every slot advances every trip; carried slots keep their own state.
    assert torch.equal(mixed[[0, 2, 3, 4], 1], later[[0, 2, 3, 4], 1] + 3)
    st, t_alg1, warm = draws.init_alg1(seeds[0], 12, 9, 20)
    assert torch.equal(t_alg1, t0[0]) and st.shape == (1, 2)
    assert len(set(warm.tolist())) == 20 and int(warm.max()) < 108
    u = draws.uniform(seeds[0], (12, 9))
    assert u.shape == (12, 9) and ((u >= 0) & (u < 1)).all()


# ---------------------------------------------------------------------------
# fidelity knobs and prereveal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "chain"])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["float", "tensor"])
def test_alpha_scale_one_is_bit_identical_to_no_knob(fused, as_tensor):
    H, a, b, keys = _case(34)
    seeds = key_data(keys)
    base = run_pooled_bandit(_t_cells(H), _t(a), _t(b), seeds, CFG,
                             fused=fused, draws=REPLAY)
    one = torch.tensor(1.0) if as_tensor else 1.0
    cap = torch.tensor(0) if as_tensor else 0
    got = run_pooled_bandit(_t_cells(H), _t(a), _t(b), seeds, CFG,
                            fused=fused, draws=REPLAY, alpha_scale=one,
                            round_cap=cap)
    assert_result_equal(got, base)


KNOBS = [(2.0, 0), (4.0, 8), (8.0, 4), (1.0, 3)]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "chain"])
@pytest.mark.parametrize("alpha_scale,round_cap", KNOBS)
def test_knobs_match_jax(alpha_scale, round_cap, fused):
    H, a, b, keys = _case(35)
    want = _j_knobs(jnp.asarray(H), jnp.asarray(a), jnp.asarray(b), keys,
                    jnp.float32(alpha_scale), jnp.int32(round_cap),
                    fused=fused)
    got = run_pooled_bandit(_t_cells(H), _t(a), _t(b), key_data(keys), CFG,
                            fused=fused, draws=REPLAY,
                            alpha_scale=torch.tensor(alpha_scale),
                            round_cap=round_cap)
    assert_result_equal(got, want, exact=False)
    if round_cap:
        assert int(got.rounds.max()) <= round_cap


def _prereveal_case(seed, poison):
    H, a, b, keys = _case(seed)
    rng = np.random.default_rng(seed)
    pr = rng.random(H.shape) < 0.1
    pv = H.copy()
    if poison:
        pr[1, 3, :2] = True
        pv[1, 3, 0] = np.nan
    return H, a, b, keys, pr, pv


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "chain"])
@pytest.mark.parametrize("poison", [False, True], ids=["clean", "nan-seed"])
def test_prereveal_matches_jax(fused, poison):
    H, a, b, keys, pr, pv = _prereveal_case(36, poison)
    want = _j_prereveal(jnp.asarray(H), jnp.asarray(a), jnp.asarray(b),
                        keys, jnp.asarray(pr), jnp.asarray(pv), fused=fused)
    got = run_pooled_bandit(_t_cells(H), _t(a), _t(b), key_data(keys), CFG,
                            fused=fused, draws=REPLAY, prereveal=_t(pr),
                            prereveal_vals=_t(pv))
    assert_result_equal(got, want, exact=False)
    assert int(got.quarantined.sum()) == int(poison)
    # prerevealed cells count as revealed
    assert bool(got.revealed[_t(pr)].all())


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "chain"])
def test_prereveal_under_a_carry_matches_jax(fused):
    """A refill's prereveal seeds only the fresh slot: carried slots keep
    their state, under either body, as in JAX. Slice 0 starts 4 queries,
    slice 1 refills slot 1 with another query (prereveal given for every
    slot), slice 2 carries on."""
    first = _prereveal_case(37, False)
    other = _prereveal_case(38, False)
    swap = np.array([False, True, False, False])
    pick = [np.where(swap.reshape((Q,) + (1,) * (x.ndim - 1)), y, x)
            for x, y in zip(first[:3] + first[4:], other[:3] + other[4:])]
    keys1 = jax.random.wrap_key_data(jnp.where(
        jnp.asarray(swap)[:, None], jax.random.key_data(other[3]),
        jax.random.key_data(first[3])))
    slices = [(first[:3], first[3], first[4:], np.ones(Q, bool)),
              (pick[:3], keys1, pick[3:], swap),
              (pick[:3], keys1, pick[3:], np.zeros(Q, bool))]
    j_state = j_init_state(Q, N, T)
    t_state = init_frontier_state(Q, N, T, device="cpu")
    for (h, a, b), keys, (pr, pv), fresh in slices:
        want, j_state = j_slice(
            _j_cells(jnp.asarray(h)), jnp.asarray(a), jnp.asarray(b), keys,
            J_CFG, j_state, jnp.asarray(fresh), trip_limit=3, fused=fused,
            prereveal=jnp.asarray(pr), prereveal_vals=jnp.asarray(pv))
        got, t_state = run_pooled_slice(
            _t_cells(h), _t(a), _t(b), key_data(keys), CFG, t_state,
            _t(fresh), trip_limit=3, fused=fused, draws=REPLAY,
            prereveal=_t(pr), prereveal_vals=_t(pv))
        assert_result_equal(got, want, exact=False)
        assert_state_matches_jax(t_state, j_state)
