"""The port's int8-compressed data-parallel training against the JAX
package, on the CPU.

``train/compression.py`` at S = 4 shards of a one-process mesh against
JAX's functions under ``jax.vmap(..., axis_name="x")``, which binds their
collectives (pmax, psum, all_to_all, all_gather) in one process: two
rounds of error feedback, outputs and residuals per shard. Quantized
values are integers, so where the two sides' scales agree (they take the
max of the same floats) the outputs agree to float rounding: atol 1e-6.
``topk_sparsify`` keeps ties (so more than k), exactly as JAX.
``train/compressed_step.py``: the step at S = 1 against JAX's on
``jax.make_mesh((1,), ("data",))`` (loss atol 1e-5, parameters atol 1e-5
at lr 1e-3 and AdamW eps 1e-4, the error buffer atol 1e-6); at S = 4 with
``compress=False`` against the port's plain step on the whole batch
(equal row counts: the mean of the shard means is the batch mean); and at
S = 4 with compression the loss falls by 0.3 within 25 steps, JAX's own
bar (``tests/test_dist.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LMConfig as JLMConfig
from repro.models.transformer import init_lm as jinit_lm
from repro.train import compressed_step as JCS
from repro.train import compression as JC
from repro.train import optimizer as JO
from repro_torch.configs.base import LMConfig
from repro_torch.dist.mesh import make_mesh
from repro_torch.models.convert import lm_from_jax
from repro_torch.models.transformer import init_lm
from repro_torch.train import compression as C
from repro_torch.train.compressed_step import (init_compressed_state,
                                               make_compressed_lm_train_step)
from repro_torch.train.optimizer import adamw
from repro_torch.train.train_step import init_train_state, \
    make_lm_train_step, named_params
from test_torch_threads import cap_torch_threads

cap_torch_threads()

S = 4
SPEC = dict(name="t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
            d_head=16, d_ff=64, vocab=128)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _grads(rng, shapes):
    """S shards' gradients: dicts of float32 arrays, stacked on axis 0."""
    return {k: (rng.standard_normal((S,) + s) * (1 + i)).astype(np.float32)
            for i, (k, s) in enumerate(shapes.items())}


def _per_shard(stacked):
    return [{k: torch.from_numpy(v[i].copy()) for k, v in stacked.items()}
            for i in range(S)]


# leaves with and without padding to a multiple of S (7 * 5 = 35)
SHAPES = {"w": (6, 8), "odd": (7, 5), "b": (3,)}


@pytest.mark.parametrize("fn", ["int8_psum", "int8_rs_ag"])
def test_collectives_match_jax_under_vmap(fn):
    rng = np.random.default_rng(0)
    mesh = make_mesh((S,), ("x",), device="cpu")
    jfn = jax.vmap(lambda g, e: getattr(JC, fn)(g, e, "x"), axis_name="x")
    g_np = _grads(rng, SHAPES)
    err = [C.init_error_buffer(g) for g in _per_shard(g_np)]
    jerr = {k: jnp.zeros_like(v) for k, v in g_np.items()}
    for _ in range(2):                       # the residual feeds round 2
        outs, err = getattr(C, fn)(_per_shard(g_np), err, mesh)
        jouts, jerr = jfn({k: jnp.asarray(v) for k, v in g_np.items()},
                          jerr)
        for i in range(S):
            for k in SHAPES:
                _close(outs[i][k], jouts[k][i], 1e-6)
                _close(err[i][k], jerr[k][i], 1e-6)
                assert torch.equal(outs[i][k], outs[0][k])   # replicated
        g_np = _grads(rng, SHAPES)


def test_topk_sparsify_matches_jax_and_keeps_ties():
    rng = np.random.default_rng(1)
    g = {"w": rng.standard_normal(100).astype(np.float32),
         "t": np.array([3.0, -3.0, 1.0, 3.0, 0.5], np.float32)}
    e = {k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in g.items()}
    e["t"][:] = 0
    kept, err = C.topk_sparsify({k: torch.from_numpy(v) for k, v in
                                 g.items()},
                                {k: torch.from_numpy(v) for k, v in
                                 e.items()}, frac=0.3)
    jkept, jerr = JC.topk_sparsify({k: jnp.asarray(v) for k, v in
                                    g.items()},
                                   {k: jnp.asarray(v) for k, v in
                                    e.items()}, frac=0.3)
    for k in g:
        _close(kept[k], jkept[k], 0)
        _close(err[k], jerr[k], 0)
        _close(kept[k] + err[k], g[k] + e[k], 1e-6)
    assert int((kept["w"] != 0).sum()) == 30
    # k = 1 of 5, but the three entries of magnitude 3 tie: all kept
    assert kept["t"].tolist() == [3.0, -3.0, 0.0, 3.0, 0.0]


def _batch(B=4, T=16, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, SPEC["vocab"], (B, T)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1).astype(np.int32)


def _port_of(tree, cfg):
    return {k: p.detach() for k, p in lm_from_jax(
        jax.tree.map(np.asarray, tree), cfg, device="cpu").named_parameters()}


def test_compressed_step_at_one_shard_matches_jax():
    """Step 1 from equal states: parameters and error buffers equal JAX's
    (atol 1e-5 / 1e-6). Step 2 starts from states 1e-7 apart, so an entry
    within that of a rounding boundary (g + err = (q + 1/2) scale) may
    round to the other q: its quantized gradient and residual then differ
    by one step, scale = max|g| / 127 of its leaf. So after step 2 the
    gradient norm is held to rtol 1e-4 and at most 0.5 % of the residual
    entries may differ by more than 1e-5."""
    jcfg, cfg = JLMConfig(**SPEC), LMConfig(**SPEC)
    p_np = jax.tree.map(np.asarray, jinit_lm(jax.random.key(0), jcfg))
    toks, tgts = _batch()
    opt, jopt = adamw(1e-3, eps=1e-4), JO.adamw(1e-3, eps=1e-4)
    jstate = JCS.init_compressed_state(jax.tree.map(jnp.asarray, p_np), jopt)
    jstep = jax.jit(JCS.make_compressed_lm_train_step(
        jcfg, jopt, jax.make_mesh((1,), ("data",))))
    state = init_compressed_state(lm_from_jax(p_np, cfg, device="cpu"), opt)
    step = make_compressed_lm_train_step(
        cfg, opt, make_mesh((1,), ("data",), device="cpu"))
    batch = {"tokens": toks, "targets": tgts}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate, jm = jstep(jstate, jbatch)
    state, m = step(state, batch)
    _close(m["loss"], jm["loss"], 1e-5)
    _close(m["grad_norm"], jm["grad_norm"], 1e-5)
    want, err = _port_of(jstate.params, cfg), _port_of(jstate.error, cfg)
    for k, p in named_params(state.params).items():
        _close(p.detach(), want[k], 1e-5)
        _close(state.error[k], err[k], 1e-5)
    assert any(torch.any(e != 0) for e in state.error.values())

    jstate, jm = jstep(jstate, jbatch)
    state, m = step(state, batch)
    _close(m["loss"], jm["loss"], 1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    err = _port_of(jstate.error, cfg)
    off = sum(int(((state.error[k] - err[k]).abs() > 1e-5).sum())
              for k in err)
    assert off <= 0.005 * sum(e.numel() for e in err.values()), off
    assert int(state.opt.step) == 2


def test_uncompressed_four_shards_equal_the_whole_batch_step():
    cfg = LMConfig(**SPEC)
    toks, tgts = _batch(B=8)
    opt = adamw(1e-3, eps=1e-4)
    a = init_compressed_state(init_lm(cfg, seed=2, device="cpu"), opt)
    b = init_train_state(init_lm(cfg, seed=2, device="cpu"), opt)
    step_a = make_compressed_lm_train_step(
        cfg, opt, make_mesh((S,), ("data",), device="cpu"), compress=False)
    a, ma = step_a(a, {"tokens": toks, "targets": tgts})
    b, mb = make_lm_train_step(cfg, opt)(b, {"tokens": toks,
                                             "targets": tgts})
    _close(ma["loss"], mb["loss"], 1e-5)
    _close(ma["grad_norm"], mb["grad_norm"], 1e-5)
    for k, p in named_params(a.params).items():
        _close(p.detach(), named_params(b.params)[k].detach(), 1e-5)
    assert all(torch.all(e == 0) for e in a.error.values())


def test_compressed_step_at_four_shards_converges():
    cfg = LMConfig(**SPEC)
    toks, tgts = _batch(B=8, seed=3)
    opt = adamw(1e-3)
    state = init_compressed_state(init_lm(cfg, seed=0, device="cpu"), opt)
    step = make_compressed_lm_train_step(
        cfg, opt, make_mesh((S,), ("data",), device="cpu"))
    losses = []
    for _ in range(25):
        state, m = step(state, {"tokens": toks, "targets": tgts})
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.3, losses
    assert any(torch.any(e != 0) for e in state.error.values())
    # 35 elements pad to 36: 2 x 3 x 9 int8 bytes + 2 x 4 x 3 scalar bytes
    assert C.int8_rs_ag_wire_bytes([35, 8], S) == 54 + 24 + 12 + 24
