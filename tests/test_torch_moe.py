"""The port's MoE layers and MoE backbones against the JAX package, on the
CPU.

``moe_ffn`` (no drop at capacity factor 8, dropping at 1.0 and 0.5, a
capacity whose S * k / E * cf ends in .5, ``no_drop=True``; top_k 1 / 2 /
6, E 4 / 8 / 64 at width 64; silu and gelu), exact router ties and
``moe_aux_loss``; a MoE ``DecoderLM`` on ``tests/test_models_lm.py``'s
"moe" flavour and a dropping variant (train / hidden / prefill / four
decode steps / ``generate``); ``encode_tokens`` on a MoE backbone and
tokens -> ``serve_queries`` dense and bandit; the two MoE configs, and
both at a cut depth and width through the port's entry points. Inputs are
numpy arrays from a seed, handed to both packages; JAX's parameters cross
through ``models.convert``.

Routing is compared exactly: experts by rank, each slot's position in its
expert and which slots fit the capacity. A near-tie in the router (top-k
gap below 1e-4 in either package) may flip under the frameworks' float
noise; ``models.moe.compare_routing`` counts such flips, fails any other,
and every logit row of that batch row from the flipped token on is left
out of the comparison (it depends on the flip). JAX's per-layer routing
is read with ``jax.debug.callback`` from a wrapper around the
``moe_ffn`` its transformer calls.

Tolerances as ``tests/test_torch_lm.py``: atol 1e-5 for one layer, 1e-4
for whole forwards, and greedy ids equal while JAX's top-2 gap exceeds
1e-3. Router weights (a softmax of the top-k logits) to atol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jtransformer
from repro.configs import REGISTRY as JREGISTRY
from repro.configs.base import LMConfig as JLMConfig
from repro.models.colbert import encode_tokens as jencode
from repro.models.colbert import init_li_head as jinit_li_head
from repro.models.moe import init_moe as jinit_moe
from repro.models.moe import moe_aux_loss as jmoe_aux_loss
from repro.models.moe import moe_ffn as jmoe_ffn
from repro.models.transformer import forward_decode as jforward_decode
from repro.models.transformer import forward_hidden as jforward_hidden
from repro.models.transformer import forward_prefill as jforward_prefill
from repro.models.transformer import forward_train as jforward_train
from repro.models.transformer import init_lm as jinit_lm
from repro.serve.engine import generate as jgenerate
from repro_torch.configs import get_config
from repro_torch.configs.base import LMConfig
from repro_torch.models.colbert import encode_tokens, init_li_head
from repro_torch.models.convert import li_head_from_jax, lm_from_jax
from repro_torch.models.moe import (MoE, capacity_of, compare_routing,
                                    moe_aux_loss, moe_ffn, moe_routing,
                                    record_routing, routing_by_layer)
from repro_torch.models.transformer import (DecoderLM, forward_decode,
                                            forward_hidden, forward_prefill,
                                            forward_train, init_lm)
from repro_torch.serve import generate, serve_step
from test_torch_colbert import L as DOC_L
from test_torch_colbert import _jax_serve, _port_serve, _tokens
from test_torch_threads import cap_torch_threads

cap_torch_threads()

LAYER_ATOL, FWD_ATOL, GAP, W_ATOL, TIE = 1e-5, 1e-4, 1e-3, 1e-6, 1e-4
D, F_FF = 64, 96
S, MAX_SEQ, STEPS, PROMPT, NEW = 16, 32, 4, 6, 6

MOE = dict(name="m", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
           d_head=16, d_ff=0, moe=True, n_experts=4, experts_top_k=2,
           moe_d_ff=96, vocab=256, moe_capacity_factor=8.0)
FLAVORS = {"moe": MOE,                                     # no token dropped
           "moe-drop": dict(MOE, name="md", moe_capacity_factor=1.0)}


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _port_moe(p_np) -> MoE:
    E, Dm, Ff = p_np["w_gate"].shape
    m = MoE(Dm, Ff, E, device="cpu")
    with torch.no_grad():
        for name, v in p_np.items():
            getattr(m, name).copy_(torch.from_numpy(np.array(v)))
    return m


def _jax_routing(p, x, top_k, capacity):
    """JAX's routing, written out from ``repro.models.moe.moe_ffn``'s own
    lines (the JAX package keeps it inside the function)."""
    B, S_, _ = x.shape
    E = p["router"].shape[-1]
    logits = x.astype(jnp.float32) @ p["router"].astype(jnp.float32)
    top_vals, top_idx = jax.lax.top_k(logits, top_k)
    top_w = jax.nn.softmax(top_vals, axis=-1)
    onehot = jax.nn.one_hot(top_idx.reshape(B, S_ * top_k), E,
                            dtype=jnp.float32)
    pos = jnp.cumsum(onehot, axis=1) - 1.0
    pos_in_expert = jnp.sum(pos * onehot, axis=-1)
    return (np.asarray(top_idx), np.asarray(top_w),
            np.asarray(pos_in_expert).astype(np.int64),
            np.asarray(pos_in_expert < capacity))


def _jax_gap(logits, top_k):
    if top_k >= logits.shape[-1]:
        return jnp.full(logits.shape[:-1], jnp.inf)
    vals, _ = jax.lax.top_k(logits, top_k + 1)
    return vals[..., top_k - 1] - vals[..., top_k]


def _by_layer(log, n_layers):
    """JAX's log as ``routing_by_layer`` groups the port's."""
    return [(torch.cat([r[0] for r in log[i::n_layers]], 1),
             torch.cat([r[1] for r in log[i::n_layers]], 1))
            for i in range(n_layers)]


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

# (E, top_k, capacity_factor, act, no_drop, S); S*k/E*cf: 8.0 -> 32 (no
# drop), 4.0, 2.0, 0.5 -> 1 (max(1, .)), 2.5 -> 2 and 3.5 -> 4 (half to
# even), 3.0 at E = 64, and the worst case.
FFN_CASES = {
    "e4k2-cf8-nodrop": (4, 2, 8.0, "silu", False, 16),
    "e8k2-cf1-drop": (8, 2, 1.0, "silu", False, 16),
    "e8k1-cf05-gelu": (8, 1, 0.5, "gelu", False, 16),
    "e8k1-cf05-min1": (8, 1, 0.5, "silu", False, 4),
    "e4k1-cf1-2.5": (4, 1, 1.0, "silu", False, 10),
    "e4k1-cf1-3.5": (4, 1, 1.0, "gelu", False, 14),
    "e64k6-cf1": (64, 6, 1.0, "silu", False, 32),
    "e64k6-no_drop": (64, 6, 1.25, "silu", True, 16),
    "e8k2-no_drop-gelu": (8, 2, 0.5, "gelu", True, 16),
}


@pytest.mark.parametrize("case", list(FFN_CASES))
def test_moe_ffn_matches_jax(case):
    E, k, cf, act, no_drop, S_ = FFN_CASES[case]
    rng = np.random.default_rng(len(case))
    p_np = jax.tree.map(np.asarray, jinit_moe(jax.random.key(E + k), D,
                                              F_FF, E))
    x = rng.standard_normal((2, S_, D)).astype(np.float32)
    p = jax.tree.map(jnp.asarray, p_np)
    want = jmoe_ffn(p, jnp.asarray(x), top_k=k, act=act, capacity_factor=cf,
                    no_drop=no_drop)
    m = _port_moe(p_np)
    got = moe_ffn(m, torch.from_numpy(x), top_k=k, act=act,
                  capacity_factor=cf, no_drop=no_drop)
    _close(got, want, LAYER_ATOL)

    cap = capacity_of(S_, k, E, cf, no_drop)
    want_cap = (S_ * k if no_drop
                else int(max(1, round(S_ * k / E * cf))))
    assert cap == min(want_cap, S_ * k)
    j_idx, j_w, j_pos, j_keep = _jax_routing(p, jnp.asarray(x), k, cap)
    r = moe_routing(m, torch.from_numpy(x), top_k=k, capacity=cap)
    np.testing.assert_array_equal(r.top_idx.numpy(), j_idx)
    np.testing.assert_array_equal(r.pos_in_expert.numpy(), j_pos)
    np.testing.assert_array_equal(r.keep.numpy(), j_keep)
    _close(r.top_w, j_w, W_ATOL)
    # The dropping cases drop, the others keep every slot.
    assert bool(r.keep.all()) == (no_drop or cf == 8.0)


def test_capacity_rounds_half_to_even():
    assert capacity_of(10, 1, 4, 1.0) == 2          # 2.5, not ceil's 3
    assert capacity_of(14, 1, 4, 1.0) == 4          # 3.5
    assert capacity_of(4, 1, 8, 0.5) == 1           # 0.25 -> at least 1
    assert capacity_of(16, 2, 4, 8.0) == 32         # at most S * k
    assert capacity_of(1, 6, 64, 1.25, no_drop=True) == 6
    # The consistency setting: cf = E / k makes the capacity S.
    for S_ in (1, 64, 68, 4100):
        assert capacity_of(S_, 6, 64, 64 / 6) == S_
        assert capacity_of(S_, 2, 8, 8 / 2) == S_


def test_router_ties_pick_the_lowest_experts():
    """Zero router weights: every logit ties, and both packages route
    every token to experts 0..k-1 (lower index first, as lax.top_k)."""
    E, k = 8, 3
    p_np = jax.tree.map(np.asarray, jinit_moe(jax.random.key(1), D, F_FF, E))
    p_np["router"] = np.zeros_like(p_np["router"])
    x = np.random.default_rng(5).standard_normal((2, 12, D)).astype(
        np.float32)
    p = jax.tree.map(jnp.asarray, p_np)
    m = _port_moe(p_np)
    j_idx, j_w, _, _ = _jax_routing(p, jnp.asarray(x), k, 12)
    r = moe_routing(m, torch.from_numpy(x), top_k=k, capacity=12)
    assert (r.top_idx.numpy() == np.arange(k)).all()
    np.testing.assert_array_equal(r.top_idx.numpy(), j_idx)
    _close(r.top_w, j_w, W_ATOL)
    for cf in (1.0, 4.0):                     # 1.0 drops: 36 slots, cap 4
        _close(moe_ffn(m, torch.from_numpy(x), top_k=k, capacity_factor=cf),
               jmoe_ffn(p, jnp.asarray(x), top_k=k, capacity_factor=cf),
               LAYER_ATOL)


@pytest.mark.parametrize("E,k", [(4, 2), (64, 6)])
def test_moe_aux_loss_matches_jax(E, k):
    p_np = jax.tree.map(np.asarray, jinit_moe(jax.random.key(E), D, F_FF, E))
    x = np.random.default_rng(E).standard_normal((3, 10, D)).astype(
        np.float32)
    want = jmoe_aux_loss(jax.tree.map(jnp.asarray, p_np), jnp.asarray(x),
                         top_k=k)
    got = moe_aux_loss(_port_moe(p_np), torch.from_numpy(x), top_k=k)
    assert got.shape == ()
    _close(got, want, LAYER_ATOL)


def test_dropped_slot_adds_zero_to_a_kept_token():
    """A dropped slot points at slot capacity - 1 of its expert, where a
    kept token may sit: the dispatch must add, not assign. One token per
    row routed to expert 0 beyond a capacity of 1 leaves the first token's
    output untouched."""
    E = 2
    m = MoE(D, F_FF, E, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for w in (m.w_gate, m.w_up, m.w_down):
            w.copy_(torch.randn(w.shape, generator=gen) * 0.1)
        m.router.zero_()
        m.router[0, 0] = 1.0                   # x[..., 0] > 0 -> expert 0
    x = torch.randn((1, 4, D), generator=gen)
    x[0, :, 0] = 5.0                           # all four to expert 0
    out = moe_ffn(m, x, top_k=1, capacity_factor=0.5)   # capacity 1
    r = moe_routing(m, x, top_k=1, capacity=1)
    assert r.keep[0].tolist() == [True, False, False, False]
    alone = moe_ffn(m, x[:, :1], top_k=1, capacity_factor=2.0)
    _close(out[:, :1], alone, LAYER_ATOL)
    assert float(out[:, 1:].abs().max()) == 0.0
    assert float(out[:, 0].abs().max()) > 0.0


# ---------------------------------------------------------------------------
# a MoE DecoderLM, per flavour
# ---------------------------------------------------------------------------

def _np_cache(cache):
    return {name: tuple(np.asarray(a) for a in st)
            for name, st in cache.items()}


@pytest.fixture(scope="module", params=list(FLAVORS))
def run(request):
    """One flavour: the JAX model's outputs with its routing per call, and
    the port's converted model."""
    name = request.param
    jcfg, cfg = JLMConfig(**FLAVORS[name]), LMConfig(**FLAVORS[name])
    params_np = jax.tree.map(np.asarray, jinit_lm(jax.random.key(0), jcfg))
    params = jax.tree.map(jnp.asarray, params_np)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, (2, S)).astype(np.int32)
    out = dict(name=name, cfg=cfg, tokens=tokens,
               model=lm_from_jax(params_np, cfg, device="cpu"))
    with pytest.MonkeyPatch.context() as mp:
        log = []
        mp.setattr(jtransformer, "moe_ffn", _recording(log))

        def logged(fn):
            del log[:]
            res = fn()
            jax.effects_barrier()
            return res, list(log)

        out["train"] = logged(lambda: np.asarray(jforward_train(
            params, jcfg, tokens, remat=False)))
        out["hidden"] = logged(lambda: np.asarray(jforward_hidden(
            params, jcfg, tokens)))
        (last, cache), pre_log = logged(lambda: jforward_prefill(
            params, jcfg, tokens, max_seq=MAX_SEQ, cache_dtype=jnp.float32))
        out["prefill"] = (np.asarray(last), _np_cache(cache), pre_log)
        steps, cur, dec_log = [], jnp.argmax(last, -1), list(pre_log)
        for step in range(STEPS):
            (dec, cache), step_log = logged(lambda: jforward_decode(
                params, jcfg, cur, jnp.int32(S + step), cache))
            dec_log += step_log
            steps.append((np.asarray(cur), np.asarray(dec), _np_cache(cache),
                          list(dec_log)))
            cur = jnp.argmax(dec, -1)
        out["decode"] = steps
        prompt = tokens[:, :PROMPT]
        gen, out["gen_log"] = logged(lambda: np.asarray(jgenerate(
            params, jcfg, jnp.asarray(prompt), max_new_tokens=NEW)))
    out["gen"] = gen
    out["gen_logits"] = np.asarray(jforward_train(
        params, jcfg, jnp.asarray(gen), remat=False))[:, PROMPT - 1:-1]
    return out


def _recording(log):
    def record(idx, gap):
        log.append((torch.from_numpy(np.asarray(idx).astype(np.int64)),
                    torch.from_numpy(np.asarray(gap))))

    def wrapped(p, x, *, top_k, **kw):
        logits = x.astype(jnp.float32) @ p["router"].astype(jnp.float32)
        _, idx = jax.lax.top_k(logits, top_k)
        jax.debug.callback(record, idx, _jax_gap(logits, top_k),
                           ordered=True)
        return jmoe_ffn(p, x, top_k=top_k, **kw)
    return wrapped


def _rule(want_log, got_log, n_layers):
    """compare_routing on JAX's and the port's logs: no wide flip."""
    diff = compare_routing(_by_layer(want_log, n_layers),
                           routing_by_layer(got_log, n_layers),
                           gap_tol=TIE)
    assert diff.wide == 0, diff
    return diff


def _close_rows(got, want, first, atol):
    """Rows (b, t) with t < first[b]: the ones no near-tie flip reaches."""
    got, want = np.asarray(got), np.asarray(want)
    for b in range(got.shape[0]):
        f = int(first[b])
        _close(got[b, :f], want[b, :f], atol)


def test_moe_forward_train_and_hidden_match_jax(run):
    cfg, model = run["cfg"], run["model"]
    n = cfg.n_layers
    for fn, key in ((forward_train, "train"), (forward_hidden, "hidden")):
        want, want_log = run[key]
        with record_routing(model) as log:
            got = fn(model, cfg, run["tokens"])
        diff = _rule(want_log, log, n)
        assert int(diff.first_tainted.min()) > S // 2, diff
        _close_rows(got, want, diff.first_tainted, FWD_ATOL)
        if run["name"] == "moe-drop":      # capacity 8 of 32 slots drops
            assert not all(bool(r.routing.keep.all()) for r in log)


def test_moe_forward_prefill_matches_jax(run):
    cfg, model = run["cfg"], run["model"]
    want_last, want_cache, want_log = run["prefill"]
    with record_routing(model) as log:
        last, cache = forward_prefill(model, cfg, run["tokens"], MAX_SEQ,
                                      cache_dtype=torch.float32)
    diff = _rule(want_log, log, cfg.n_layers)
    for b in range(2):
        if int(diff.first_tainted[b]) == S:
            _close(last[b], want_last[b], FWD_ATOL)
    for name, (k, v, pos) in want_cache.items():
        np.testing.assert_array_equal(cache[name].pos.numpy(), pos)
        for b in range(2):
            f = int(diff.first_tainted[b])
            _close(cache[name].k[:, b, :f], k[:, b, :f], FWD_ATOL)
            _close(cache[name].v[:, b, :f], v[:, b, :f], FWD_ATOL)


def test_moe_decode_matches_jax(run):
    """Four decode steps (``no_drop=True``) from JAX's tokens: logits and
    the cache after each, under the routing rule (at most one of the four
    steps may be skipped); for the no-drop flavour each step also equals
    the port's own forward_train on the grown sequence."""
    cfg, model = run["cfg"], run["model"]
    with record_routing(model) as log:
        _, cache = forward_prefill(model, cfg, run["tokens"], MAX_SEQ,
                                   cache_dtype=torch.float32)
        seq = torch.from_numpy(run["tokens"]).long()
        skipped = 0
        for step, (cur, want, _, want_log) in enumerate(run["decode"]):
            step_fn = forward_decode if step % 2 == 0 else serve_step
            dec, cache = step_fn(model, cfg, torch.tensor(cur), S + step,
                                 cache)
            diff = _rule(want_log, log, cfg.n_layers)
            ok = diff.first_tainted > S + step
            skipped += int(not bool(ok.all()))
            _close(dec[ok], want[ok], FWD_ATOL)
            seq = torch.cat([seq, torch.tensor(cur).long()[:, None]], dim=1)
            if run["name"] == "moe":
                with record_routing(model) as train_log:
                    ref = forward_train(model, cfg, seq)[:, -1]
                self_diff = compare_routing(
                    routing_by_layer(train_log, cfg.n_layers),
                    routing_by_layer(log, cfg.n_layers), gap_tol=TIE)
                assert self_diff.wide == 0, self_diff
                same = self_diff.first_tainted > S + step
                _close(dec[same], ref[same], FWD_ATOL)
    assert skipped <= 1


def test_moe_generate_matches_jax_where_the_argmax_is_clear(run):
    cfg, model = run["cfg"], run["model"]
    with record_routing(model) as log:
        got = generate(model, cfg,
                       torch.from_numpy(run["tokens"][:, :PROMPT]),
                       max_new_tokens=NEW).numpy()
    diff = _rule(run["gen_log"], log, cfg.n_layers)
    want, logits = run["gen"], run["gen_logits"]
    assert got.shape == want.shape == (2, PROMPT + NEW)
    np.testing.assert_array_equal(got[:, :PROMPT], want[:, :PROMPT])
    top2 = np.sort(logits, axis=-1)[:, :, -2:]
    gap = top2[:, :, 1] - top2[:, :, 0]
    checked = 0
    for b in range(2):
        for t in range(NEW):
            # the id at PROMPT + t is the argmax of position PROMPT - 1 + t
            if gap[b, t] <= GAP or PROMPT - 1 + t >= int(
                    diff.first_tainted[b]):
                break
            assert got[b, PROMPT + t] == want[b, PROMPT + t], (b, t)
            checked += 1
    assert checked >= 1


# ---------------------------------------------------------------------------
# the encoder and tokens -> top-K on a MoE backbone
# ---------------------------------------------------------------------------

ENC = dict(MOE, name="me", n_experts=8, experts_top_k=2,
           moe_capacity_factor=1.25, li_dim=32)


@pytest.fixture(scope="module")
def moe_encoded():
    jcfg, cfg = JLMConfig(**ENC), LMConfig(**ENC)
    k_lm, k_head = jax.random.split(jax.random.key(3))
    lm_np = jax.tree.map(np.asarray, jinit_lm(k_lm, jcfg))
    head_np = jax.tree.map(np.asarray, jinit_li_head(k_head, jcfg))
    lm = lm_from_jax(lm_np, cfg, device="cpu")
    head = li_head_from_jax(head_np, cfg, device="cpu")
    docs, mask, lens, queries = _tokens(cfg.vocab)
    qmask = np.ones(queries.shape, bool)
    jlm = jax.tree.map(jnp.asarray, lm_np)
    jhead = jax.tree.map(jnp.asarray, head_np)
    out = dict(cfg=cfg, mask=mask, lens=lens, docs=docs)
    with pytest.MonkeyPatch.context() as mp:
        for side, toks, m in (("docs", docs, mask), ("q", queries, qmask)):
            log = []
            mp.setattr(jtransformer, "moe_ffn", _recording(log))
            out[f"j_{side}"] = np.asarray(jencode(
                jlm, jhead, jcfg, jnp.asarray(toks), jnp.asarray(m))[0])
            jax.effects_barrier()
            with record_routing(lm) as tlog:
                emb, _ = encode_tokens(lm, head, cfg, torch.from_numpy(toks),
                                       torch.from_numpy(m))
            out[f"t_{side}"] = emb.numpy()
            out[f"diff_{side}"] = _rule(log, tlog, cfg.n_layers)
            out[f"keep_{side}"] = tlog
    return out


def test_moe_encode_tokens_matches_jax(moe_encoded):
    e = moe_encoded
    for side in ("docs", "q"):
        _close_rows(e[f"t_{side}"], e[f"j_{side}"],
                    e[f"diff_{side}"].first_tainted, LAYER_ATOL)
    mask = e["mask"]
    assert (e["t_docs"][~mask] == 0).all()
    # Pads are routed and take capacity: the docs' padded length decides
    # the drops (capacity round(24 * 2 / 8 * 1.25) = 8 of 48 slots).
    assert not all(bool(r.routing.keep.all()) for r in e["keep_docs"])
    assert e["keep_docs"][0].routing.top_idx.shape[1] == DOC_L


def test_moe_tokens_to_dense_top5_match_jax(moe_encoded):
    e = moe_encoded
    # No near-tie flip in these encodings: every embedding is compared.
    assert int(e["diff_docs"].near_ties) == int(e["diff_q"].near_ties) == 0
    want = _jax_serve(e["j_docs"], e["mask"], e["lens"], e["j_q"],
                      flavor="dense")
    six = _jax_serve(e["j_docs"], e["mask"], e["lens"], e["j_q"],
                     flavor="dense", k=6)
    got = _port_serve(e["t_docs"], e["mask"], e["lens"], e["t_q"],
                      flavor="dense")
    clear = (six.topk_scores[:, 4] - six.topk_scores[:, 5]) > 1e-4
    assert clear.any()
    for q in np.flatnonzero(clear):
        assert set(got.topk_ids[q]) == set(want.topk_ids[q]), q


@pytest.mark.parametrize("engine", ["pooled_fused", "pooled_chain"])
def test_moe_bandit_on_the_port_embeddings_matches_jax(moe_encoded, engine):
    e = moe_encoded
    args = (e["t_docs"], e["mask"], e["lens"], e["t_q"])
    want = _jax_serve(*args, flavor="bandit", engine=engine)
    got = _port_serve(*args, flavor="bandit", engine=engine)
    np.testing.assert_array_equal(got.topk_ids, want.topk_ids)
    np.testing.assert_array_equal(got.reveal_fraction, want.reveal_fraction)
    np.testing.assert_array_equal(got.stats[1:3], want.stats[1:3])


# ---------------------------------------------------------------------------
# the MoE configs and their entry points
# ---------------------------------------------------------------------------

def test_moe_configs_equal_jax():
    for arch, n, active in (("moonshot-v1-16b-a3b", 28_057_997_312,
                             3_974_303_744),
                            ("mixtral-8x22b", 140_630_077_440, None)):
        cfg, jcfg = get_config(arch), JREGISTRY[arch]
        got, want = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
        got.pop("shapes"), want.pop("shapes")
        assert got == want
        assert cfg.param_count() == jcfg.param_count() == n
        assert cfg.active_param_count() == jcfg.active_param_count()
        if active is not None:
            assert cfg.active_param_count() == active


def _narrow(arch):
    """The config at 2 layers and width 64 (experts, top-k, window, RoPE
    theta kept): the full width runs on the card."""
    return dataclasses.replace(get_config(arch), n_layers=2, d_model=64,
                               n_heads=4, n_kv_heads=2, d_head=16, d_ff=48,
                               moe_d_ff=48, vocab=512, li_dim=32)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mixtral-8x22b"])
def test_moe_configs_run_through_the_entry_points(arch):
    cfg = _narrow(arch)
    jcfg = JLMConfig(**dataclasses.asdict(cfg))
    params_np = jax.tree.map(np.asarray, jinit_lm(jax.random.key(1), jcfg))
    model = lm_from_jax(params_np, cfg, device="cpu")
    assert isinstance(model, DecoderLM) and model.blocks[0].mlp is None
    assert model.blocks[0].moe.w_gate.shape == (cfg.n_experts, 64, 48)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 12))
    jlog = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtransformer, "moe_ffn", _recording(jlog))
        want = np.asarray(jforward_train(
            jax.tree.map(jnp.asarray, params_np), jcfg,
            tokens.astype(np.int32), remat=False))
        jax.effects_barrier()
    with record_routing(model) as log:
        got = forward_train(model, cfg, tokens)
    assert len(log) == cfg.n_layers
    assert log[0].routing.top_idx.shape == (2, 12, cfg.experts_top_k)
    diff = _rule(jlog, log, cfg.n_layers)
    _close_rows(got, want, diff.first_tainted, FWD_ATOL)
    out = generate(model, cfg, tokens[:, :5], max_new_tokens=3)
    assert out.shape == (2, 8) and int(out.max()) < cfg.vocab
    own = init_lm(cfg, seed=2, device="cpu")
    head = init_li_head(cfg, seed=2, device="cpu")
    emb, m = encode_tokens(own, head, cfg, tokens, np.ones((2, 12), bool))
    assert emb.shape == (2, 12, 32) and torch.isfinite(emb).all()


def test_moe_init_is_seeded_and_conversion_checks_the_tree():
    cfg = LMConfig(**MOE)
    a, b = (init_lm(cfg, seed=7, device="cpu") for _ in range(2))
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name
    moe = a.blocks[0].moe
    assert moe.router.shape == (64, 4) and moe.w_down.shape == (4, 96, 64)
    assert abs(float(moe.w_gate.std()) - 64 ** -0.5) < 0.02
    assert abs(float(moe.w_down.std()) - 96 ** -0.5) < 0.02
    dense_np = jax.tree.map(np.asarray, jinit_lm(
        jax.random.key(0), JLMConfig(**dict(MOE, moe=False, d_ff=96))))
    with pytest.raises(ValueError, match="only one"):
        lm_from_jax(dense_np, cfg, device="cpu")
    moe_np = jax.tree.map(np.asarray, jinit_lm(jax.random.key(0),
                                               JLMConfig(**MOE)))
    with pytest.raises(ValueError, match="shape"):
        lm_from_jax(moe_np, dataclasses.replace(cfg, n_experts=8),
                    device="cpu")
