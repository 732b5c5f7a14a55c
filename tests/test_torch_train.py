"""The port's training stack against the JAX package, on the CPU.

``train/optimizer.py`` (AdamW over 3 updates with f32 and bf16 leaves,
the two schedules, ``global_norm``), ``train/train_step.py`` (``lm_loss``
and its gradients on the four dense flavours of ``tests/test_torch_lm.py``
with some targets -1, ``remat`` against no remat bit for bit, strided
microbatches, a MoE step, a step of each recsys model and of PNA) and
``models/convert.py::train_state_from_jax``. Inputs are numpy arrays from
seeds handed to both packages; JAX's parameters, gradients and moments
cross through the conversion's name maps.

Tolerances (float32 on both sides, sums in different orders): loss atol
1e-5 (PNA's loss of ~12: rtol 1e-5); gradients and updated moments atol
1e-5; updated parameters atol lr / 100. The step tests run AdamW with eps
1e-4: with the default 1e-8 an entry's first update is lr g / (|g| +
1e-8), so a gradient entry near 1e-8 (a sum of cancelling terms, whose
float noise is of that order) moves its update by up to lr; eps 1e-4
bounds that to lr |dg| / 1e-4, and the moments hold the gradients
themselves to 1e-5. AdamW alone runs the defaults on gradients far from
0, parameters within atol 1e-6; a bf16 parameter within one bf16 ulp
(2^-7 relative) of JAX's, as both round a float32 value that may differ
in its last bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GNNConfig as JGNNConfig
from repro.configs.base import LMConfig as JLMConfig
from repro.configs.base import RecsysConfig as JRecsysConfig
from repro.models import gnn as JG
from repro.models import recsys as JR
from repro.models import transformer as jtransformer
from repro.models.transformer import init_lm as jinit_lm
from repro.train import optimizer as JO
from repro.train import train_step as JT
from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.models.colbert import encode_tokens, init_li_head
from repro_torch.models.convert import (gnn_from_jax, lm_from_jax,
                                        model_from_jax, recsys_from_jax,
                                        train_state_from_jax)
from repro_torch.models.moe import compare_routing, record_routing, \
    routing_by_layer
from repro_torch.models.transformer import forward_train, init_lm
from repro_torch.serve import generate, serve_step
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as T
from test_torch_lm import FLAVORS, _random_bias
from test_torch_moe import MOE, _by_layer, _recording
from test_torch_recsys import SMALL, VOCAB, _field_ids, _history
from test_torch_threads import cap_torch_threads

cap_torch_threads()

LOSS_ATOL, GRAD_ATOL, PARAM_ATOL = 1e-5, 1e-5, 1e-5     # lr 1e-3
EPS = 1e-4                          # AdamW's eps in the step tests


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=rtol,
                               atol=atol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _named(tree_np, cfg):
    """A JAX tree (params-shaped) by the port's parameter names."""
    mod = model_from_jax(tree_np, cfg, dtype=torch.float32, device="cpu")
    return {k: p.detach() for k, p in mod.named_parameters()}


def _state_close(state, jstate, cfg, atol=PARAM_ATOL):
    """The port's TrainState against JAX's: parameters, m, v, step."""
    want = _named(_np(jstate.params), cfg)
    for k, p in state.params.named_parameters():
        _close(p.detach().float(), want[k], atol)
    for field in ("m", "v"):
        want = _named(_np(getattr(jstate.opt, field)), cfg)
        for k, t in getattr(state.opt, field).items():
            _close(t, want[k], GRAD_ATOL)
    assert int(state.opt.step) == int(jstate.opt.step)


def _lm_setup(flavor, seed=0):
    jcfg, cfg = JLMConfig(**FLAVORS[flavor]), LMConfig(**FLAVORS[flavor])
    rng = np.random.default_rng(seed)
    p_np = _random_bias(_np(jinit_lm(jax.random.key(seed), jcfg)), rng)
    return jcfg, cfg, p_np, rng


def _lm_batch(rng, cfg, B, S, holes=True):
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1).astype(np.int32)
    if holes:                       # masked targets, unevenly over rows
        targets[0, -3:] = -1
        targets[B - 1, :5] = -1
    return tokens, targets


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_schedules_and_global_norm_match_jax():
    for make in ("cosine_schedule", "linear_schedule"):
        fn, jfn = getattr(O, make)(3e-3, 5, 40), getattr(JO, make)(3e-3, 5,
                                                                    40)
        for s in (0, 1, 4, 5, 6, 17, 39, 40, 55):
            got = fn(torch.tensor(s, dtype=torch.int32))
            want = jfn(jnp.int32(s))
            assert got.dtype == torch.float32
            _close(got, want, 1e-10)
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": rng.standard_normal(11).astype(np.float32)}
    got = O.global_norm({k: torch.from_numpy(v) for k, v in tree.items()})
    _close(got, JO.global_norm(jax.tree.map(jnp.asarray, tree)), 1e-6)


def test_adamw_three_updates_match_jax():
    """Three updates under a cosine schedule, clip active (norm > 1) and
    weight decay on every leaf, f32 and bf16 leaves: parameters, moments,
    step and gnorm against JAX's."""
    rng = np.random.default_rng(1)
    shapes = {"w": (6, 4), "b": (4,), "e": (9, 3)}
    p_np = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    sched = (O.cosine_schedule(1e-2, 1, 5), JO.cosine_schedule(1e-2, 1, 5))
    opt, jopt = O.adamw(sched[0]), JO.adamw(sched[1])
    params = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    params["h"] = torch.from_numpy(
        rng.standard_normal((5, 5)).astype(np.float32)).to(torch.bfloat16)
    jparams = {k: jnp.asarray(v) for k, v in p_np.items()}
    jparams["h"] = jnp.asarray(params["h"].float().numpy(), jnp.bfloat16)
    state, jstate = opt.init(params), jopt.init(jparams)
    assert state.m["h"].dtype == torch.float32
    for i in range(3):
        g_np = {k: (2.0 * rng.standard_normal(np.shape(v))
                    ).astype(np.float32) for k, v in jparams.items()}
        grads = {k: torch.from_numpy(v) for k, v in g_np.items()}
        grads["h"] = grads["h"].to(torch.bfloat16)
        jgrads = {k: jnp.asarray(v) for k, v in g_np.items()}
        jgrads["h"] = jgrads["h"].astype(jnp.bfloat16)
        params, state, gnorm = opt.update(grads, state, params)
        jparams, jstate, jgnorm = jopt.update(jgrads, jstate, jparams)
        _close(gnorm, jgnorm, 1e-5)
        assert int(state.step) == int(jstate.step) == i + 1
        for k in shapes:
            _close(params[k], jparams[k], 1e-6)
            _close(state.m[k], jstate.m[k], GRAD_ATOL)
            _close(state.v[k], jstate.v[k], GRAD_ATOL)
        assert params["h"].dtype == torch.bfloat16
        want = np.asarray(jparams["h"].astype(jnp.float32))
        np.testing.assert_allclose(params["h"].float().numpy(), want,
                                   rtol=2.0 ** -7, atol=0)


# ---------------------------------------------------------------------------
# LM loss, remat, microbatches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flavor", list(FLAVORS))
def test_lm_loss_and_grads_match_jax(flavor):
    """chunk_tokens=12 at B=2, S=16: chunks of 6 walk down to 4 (4
    chunks)."""
    jcfg, cfg, p_np, rng = _lm_setup(flavor)
    tokens, targets = _lm_batch(rng, cfg, 2, 16)
    jloss, jgrads = jax.value_and_grad(JT.lm_loss)(
        jax.tree.map(jnp.asarray, p_np), jcfg, jnp.asarray(tokens),
        jnp.asarray(targets), chunk_tokens=12)
    model = lm_from_jax(p_np, cfg, device="cpu")
    loss, grads = T.value_and_grad(
        lambda: T.lm_loss(model, cfg, tokens, targets, chunk_tokens=12),
        model)
    _close(loss, jloss, LOSS_ATOL)
    want = _named(_np(jgrads), cfg)
    assert set(grads) == set(want)
    for k, g in grads.items():
        _close(g, want[k], GRAD_ATOL)
    assert not any(p.requires_grad for p in model.parameters())


REMAT = dict(FLAVORS, nested=dict(name="n", n_layers=9, d_model=32,
                                  n_heads=2, n_kv_heads=1, d_head=16,
                                  d_ff=48, vocab=128, qkv_bias=True),
             pairs=dict(FLAVORS["gemma-style"], name="p", n_layers=8))


@pytest.mark.parametrize("flavor", list(REMAT))
def test_remat_changes_no_bit(flavor):
    """Loss and gradients with remat=True equal remat=False bit for bit:
    per layer (per gemma2 pair: 'gemma-style', 'pairs' with 4 pairs,
    nested 2 x 2) and nested sqrt-L ('nested': 9 layers, 3 blocks of 3)
    in forward_hidden, per chunk in the loss, and forward_train's."""
    cfg = LMConfig(**REMAT[flavor])
    model = init_lm(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    tokens, targets = _lm_batch(rng, cfg, 2, 16)
    out = {}
    for remat in (False, True):
        out[remat] = T.value_and_grad(
            lambda: T.lm_loss(model, cfg, tokens, targets, chunk_tokens=8,
                              remat=remat), model)
        out[("train", remat)] = T.value_and_grad(
            lambda: forward_train(model, cfg, tokens, remat=remat).square()
            .mean(), model)
    for key in ((False, True), (("train", False), ("train", True))):
        (la, ga), (lb, gb) = out[key[0]], out[key[1]]
        assert torch.equal(la, lb)
        for k in ga:
            assert torch.equal(ga[k], gb[k]), k


def test_microbatches_match_jax_strided_split():
    """num_microbatches=2 against JAX's step (rows j, j+2, ... form
    microbatch j; masked targets make the split matter), and the port's
    m=2 gradients against those of its two strided row sets."""
    jcfg, cfg, p_np, rng = _lm_setup("dense-gqa", seed=4)
    tokens, targets = _lm_batch(rng, cfg, 4, 16)
    targets[1, :12] = -1             # rows 1 and 3 (microbatch 1) sparse
    opt, jopt = O.adamw(1e-3, eps=EPS), JO.adamw(1e-3, eps=EPS)
    jparams = jax.tree.map(jnp.asarray, p_np)
    jstate = JT.TrainState(jparams, jopt.init(jparams))
    jstep = jax.jit(JT.make_lm_train_step(jcfg, jopt, chunk_tokens=16,
                                          num_microbatches=2))
    jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens),
                                "targets": jnp.asarray(targets)})
    state = T.init_train_state(lm_from_jax(p_np, cfg, device="cpu"), opt)
    step = T.make_lm_train_step(cfg, opt, chunk_tokens=16,
                                num_microbatches=2)
    state, m = step(state, {"tokens": tokens, "targets": targets})
    _close(m["loss"], jm["loss"], LOSS_ATOL)
    _close(m["grad_norm"], jm["grad_norm"], 1e-5)
    _state_close(state, jstate, cfg)

    # microbatch j is rows j, j + 2 (strided): the f32 gradients are the
    # mean of those two row sets' gradients, the loss the mean of theirs
    model = lm_from_jax(p_np, cfg, device="cpu")
    l2, g2 = T.lm_grads(model, cfg, tokens, targets, chunk_tokens=16,
                        num_microbatches=2)
    _close(l2, m["loss"], 0)
    halves = [T.lm_grads(model, cfg, tokens[j::2], targets[j::2],
                         chunk_tokens=16) for j in range(2)]
    _close(l2, (halves[0][0] + halves[1][0]) / 2, 1e-7)
    for k in g2:
        assert g2[k].dtype == torch.float32
        want = (halves[0][1][k].float() + halves[1][1][k].float()) / 2
        _close(g2[k], want, 1e-7)


def test_moe_train_step_matches_jax():
    """One train step of the MoE flavour at capacity factor 1.0 (tokens
    dropped) and 8.0 (none): JAX's routing exactly (no flip at all), then
    loss, gradient norm and the updated state."""
    for cf in (1.0, 8.0):
        spec = dict(MOE, moe_capacity_factor=cf)
        jcfg, cfg = JLMConfig(**spec), LMConfig(**spec)
        p_np = _np(jinit_lm(jax.random.key(5), jcfg))
        rng = np.random.default_rng(5)
        tokens, targets = _lm_batch(rng, cfg, 2, 16)
        jparams = jax.tree.map(jnp.asarray, p_np)
        log = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jtransformer, "moe_ffn", _recording(log))
            jtransformer.forward_hidden(jparams, jcfg, jnp.asarray(tokens))
            jax.effects_barrier()
        model = lm_from_jax(p_np, cfg, device="cpu")
        with record_routing(model) as plog:
            T.forward_hidden(model, cfg, tokens)
        diff = compare_routing(_by_layer(log, cfg.n_layers),
                               routing_by_layer(plog, cfg.n_layers))
        assert diff.near_ties == 0 and diff.wide == 0, diff
        if cf == 1.0:
            assert not all(bool(r.routing.keep.all()) for r in plog)

        opt, jopt = O.adamw(1e-3, eps=EPS), JO.adamw(1e-3, eps=EPS)
        jstate = JT.TrainState(jparams, jopt.init(jparams))
        jstate, jm = jax.jit(JT.make_lm_train_step(jcfg, jopt))(
            jstate, {"tokens": jnp.asarray(tokens),
                     "targets": jnp.asarray(targets)})
        state = T.init_train_state(model, opt)
        state, m = T.make_lm_train_step(cfg, opt)(
            state, {"tokens": tokens, "targets": targets})
        _close(m["loss"], jm["loss"], LOSS_ATOL)
        _close(m["grad_norm"], jm["grad_norm"], 1e-5)
        _state_close(state, jstate, cfg)


# ---------------------------------------------------------------------------
# recsys and PNA steps
# ---------------------------------------------------------------------------

def _recsys_batch(name, cfg, rng, n=16):
    if name in ("fm", "autoint"):
        b = {"ids": _field_ids(rng, VOCAB, n)}
    else:
        hist, mask = _history(rng, cfg, n)
        b = {"hist_ids": hist, "hist_mask": mask,
             "target_ids": rng.integers(0, cfg.item_vocab, n
                                        ).astype(np.int32)}
    b["labels"] = rng.integers(0, 2, n).astype(np.float32)
    return b


@pytest.mark.parametrize("name", list(SMALL))
def test_recsys_train_step_matches_jax(name):
    jcfg, cfg = JRecsysConfig(**SMALL[name]), RecsysConfig(**SMALL[name])
    p_np = _np(getattr(JR, f"init_{name}")(jax.random.key(6), jcfg))
    rng = np.random.default_rng(6)
    batch = _recsys_batch(name, cfg, rng)
    opt, jopt = O.adamw(1e-2, eps=EPS), JO.adamw(1e-2, eps=EPS)
    jparams = jax.tree.map(jnp.asarray, p_np)
    jstate = JT.TrainState(jparams, jopt.init(jparams))
    jstate, jm = jax.jit(JT.make_recsys_train_step(jcfg, jopt))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = T.init_train_state(recsys_from_jax(p_np, cfg, device="cpu"), opt)
    state, m = T.make_recsys_train_step(cfg, opt)(state, batch)
    _close(m["loss"], jm["loss"], LOSS_ATOL)
    _close(m["grad_norm"], jm["grad_norm"], 1e-5)
    _state_close(state, jstate, cfg, atol=1e-4)   # lr 1e-2


PNA_SMALL = dict(name="pna", n_layers=3, d_hidden=16, n_classes=5)


def test_pna_train_step_matches_jax():
    jcfg, cfg = JGNNConfig(**PNA_SMALL), GNNConfig(**PNA_SMALL)
    p_np = _np(JG.init_pna(jax.random.key(7), jcfg, 8))
    jg = JG.random_graph(48, 200, 8, 5, seed=7)
    g = G.random_graph(48, 200, 8, 5, seed=7)
    opt, jopt = O.adamw(1e-3, eps=EPS), JO.adamw(1e-3, eps=EPS)
    jparams = jax.tree.map(jnp.asarray, p_np)
    jstate = JT.TrainState(jparams, jopt.init(jparams))
    jstate, jm = jax.jit(JT.make_gnn_train_step(jcfg, jopt))(jstate, jg)
    state = T.init_train_state(gnn_from_jax(p_np, cfg, device="cpu"), opt)
    state, m = T.make_gnn_train_step(cfg, opt)(state, g)
    _close(m["loss"], jm["loss"], 0, rtol=1e-5)
    _close(m["grad_norm"], jm["grad_norm"], 0, rtol=1e-5)
    _state_close(state, jstate, cfg)


# ---------------------------------------------------------------------------
# train_state_from_jax, serving without a graph
# ---------------------------------------------------------------------------

def test_train_state_from_jax_takes_jaxs_third_step():
    """JAX's state after 2 steps, carried across, takes a 3rd step equal
    to JAX's 3rd (cosine schedule: the carried step count matters)."""
    jcfg, cfg, p_np, rng = _lm_setup("qkv-bias", seed=8)
    sched = (O.cosine_schedule(1e-3, 1, 4), JO.cosine_schedule(1e-3, 1, 4))
    opt, jopt = O.adamw(sched[0], eps=EPS), JO.adamw(sched[1], eps=EPS)
    jparams = jax.tree.map(jnp.asarray, p_np)
    jstate = JT.TrainState(jparams, jopt.init(jparams))
    jstep = jax.jit(JT.make_lm_train_step(jcfg, jopt))
    batches = [_lm_batch(rng, cfg, 2, 16) for _ in range(3)]
    for tk, tg in batches[:2]:
        jstate, _ = jstep(jstate, {"tokens": jnp.asarray(tk),
                                   "targets": jnp.asarray(tg)})
    state = train_state_from_jax(_np(jstate), cfg, device="cpu")
    assert int(state.opt.step) == 2
    _state_close(state, jstate, cfg, atol=0)
    tk, tg = batches[2]
    jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tk),
                                "targets": jnp.asarray(tg)})
    state, m = T.make_lm_train_step(cfg, opt)(state, {"tokens": tk,
                                                      "targets": tg})
    _close(m["loss"], jm["loss"], LOSS_ATOL)
    _state_close(state, jstate, cfg)


def test_serving_entry_points_build_no_graph():
    """With every parameter asking for gradients, the serving entry
    points return tensors outside any autograd graph; a train step leaves
    the parameters as it found them."""
    cfg = LMConfig(**FLAVORS["qkv-bias"])
    model = init_lm(cfg, seed=0, device="cpu")
    head = init_li_head(cfg, seed=1, device="cpu")
    opt = O.adamw(1e-3)
    state = T.init_train_state(model, opt)
    tokens, targets = _lm_batch(np.random.default_rng(9), cfg, 2, 8, False)
    T.make_lm_train_step(cfg, opt)(state, {"tokens": tokens,
                                           "targets": targets})
    assert not any(p.requires_grad for p in model.parameters())
    model.requires_grad_(True)
    head.requires_grad_(True)
    outs = [generate(model, cfg, tokens, max_new_tokens=2)]
    outs += list(encode_tokens(model, head, cfg, tokens,
                               np.ones(tokens.shape, bool)))
    from repro_torch.models.transformer import forward_prefill
    with torch.no_grad():
        _, cache = forward_prefill(model, cfg, tokens, max_seq=12)
    outs += list(serve_step(model, cfg, tokens[:, -1], 8, cache)[:1])
    rcfg = RecsysConfig(**SMALL["fm"])
    fm = R.init_fm(rcfg, seed=0, device="cpu").requires_grad_(True)
    rng = np.random.default_rng(9)
    ctx = _field_ids(rng, VOCAB[:-1], 1)[0]
    cand = rng.integers(0, VOCAB[-1], 20)
    outs += [T.recsys_serve(fm, rcfg, {"ids": _field_ids(rng, VOCAB, 4)}),
             T.recsys_score_candidates(fm, rcfg, {"context_ids": ctx,
                                                  "cand_ids": cand}),
             R.fm_candidate_components(fm, rcfg, ctx, cand)]
    dcfg = RecsysConfig(**SMALL["din"])
    din = R.init_din(dcfg, seed=0, device="cpu").requires_grad_(True)
    hist, mask = _history(rng, dcfg, 2)
    outs.append(T.recsys_score_candidates(din, dcfg, {
        "hist_ids": hist[1], "hist_mask": mask[1],
        "cand_ids": cand % dcfg.item_vocab}))
    for o in outs:
        assert isinstance(o, torch.Tensor)
        assert not o.requires_grad and o.grad_fn is None
