"""The port's LM serving path against the JAX package, on the CPU.

Layers (``rms_norm``, ``apply_rope``, ``attention`` with and without
``q_chunk``), the KV cache writes (``write_token``, ``prefill_write`` full
and ring), the decoder's forwards (train, hidden, prefill with its cache,
four decode steps across the ring boundary) and ``generate`` (also over a
cache placed on a mesh spread across two CPU devices), on JAX's own
test flavours (``tests/test_models_lm.py``: dense GQA, SWA ring,
gemma-style local/global with softcaps, QKV bias; the MoE flavour is in
``tests/test_torch_moe.py``). The JAX parameters cross through
``models.convert.lm_from_jax``; inputs are numpy arrays from a seed, handed
to both packages.

Tolerances: atol 1e-5 for a single layer and the cache writes, atol 1e-4
for whole forwards (JAX's own decode-vs-train test uses 1e-4): both run
float32, and the frameworks' matrix products and softmaxes sum in
different orders. ``generate`` is greedy, so an argmax flips wherever two
logits are closer than that noise. The rule: a generated id must equal
JAX's wherever JAX's top-2 logit gap at that step exceeds 1e-3; from the
first step whose gap is at most 1e-3 on, the two sequences may diverge,
since every later step is conditioned on that token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.configs.base import LMConfig as JLMConfig
from repro.models import kv_cache as JKV
from repro.models import layers as JL
from repro.models.transformer import forward_decode as jforward_decode
from repro.models.transformer import forward_hidden as jforward_hidden
from repro.models.transformer import forward_prefill as jforward_prefill
from repro.models.transformer import forward_train as jforward_train
from repro.models.transformer import init_lm as jinit_lm
from repro.serve.engine import generate as jgenerate
from repro_torch.configs import get_config
from repro_torch.configs.base import LM_SHAPES, LMConfig
from repro_torch.dist import flash_decode as FD
from repro_torch.dist.mesh import make_mesh
from repro_torch.dist.sharding import lm_cache_specs
from repro_torch.models import kv_cache as KV
from repro_torch.models import layers as L
from repro_torch.models.convert import lm_from_jax
from repro_torch.models.transformer import (forward_decode, forward_hidden,
                                            forward_prefill, forward_train,
                                            init_cache, init_lm)
from repro_torch.serve import generate, serve_step
from test_torch_threads import cap_torch_threads

cap_torch_threads()

LAYER_ATOL, FWD_ATOL, GAP = 1e-5, 1e-4, 1e-3

FLAVORS = {
    "dense-gqa": dict(name="d", n_layers=3, d_model=64, n_heads=4,
                      n_kv_heads=2, d_head=16, d_ff=128, vocab=256),
    "swa-ring": dict(name="s", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=4, d_head=16, d_ff=128, vocab=256,
                     sliding_window=8),
    "gemma-style": dict(name="g", n_layers=4, d_model=64, n_heads=4,
                        n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
                        sliding_window=8, local_global_alternating=True,
                        attn_softcap=50.0, logit_softcap=30.0, act="gelu"),
    "qkv-bias": dict(name="q", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
                     qkv_bias=True),
}
S, MAX_SEQ, STEPS, PROMPT, NEW = 16, 32, 4, 6, 6


def _np_cache(cache):
    return {name: tuple(np.asarray(a) for a in st)
            for name, st in cache.items()}


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _random_bias(params_np, rng):
    """JAX initializes the QKV biases to 0; give them values, so the bias
    path is compared too."""
    for stack in ("all", "local", "global"):
        attn = params_np.get(stack, {}).get("attn", {})
        for b in ("bq", "bk", "bv"):
            if b in attn:
                attn[b] = (0.1 * rng.standard_normal(attn[b].shape)
                           ).astype(np.float32)
    return params_np


@pytest.fixture(scope="module", params=list(FLAVORS))
def run(request):
    """One flavour: the JAX model's outputs and the port's converted
    model."""
    name = request.param
    jcfg = JLMConfig(**FLAVORS[name])
    cfg = LMConfig(**FLAVORS[name])
    rng = np.random.default_rng(0)
    params_np = _random_bias(
        jax.tree.map(np.asarray, jinit_lm(jax.random.key(0), jcfg)), rng)
    params = jax.tree.map(jnp.asarray, params_np)
    tokens = rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
    out = dict(name=name, cfg=cfg, jcfg=jcfg, tokens=tokens,
               model=lm_from_jax(params_np, cfg, device="cpu"))
    out["train"] = np.asarray(jforward_train(params, jcfg, tokens,
                                             remat=False))
    out["hidden"] = np.asarray(jforward_hidden(params, jcfg, tokens))
    last, cache = jforward_prefill(params, jcfg, tokens, max_seq=MAX_SEQ,
                                   cache_dtype=jnp.float32)
    out["prefill"] = (np.asarray(last), _np_cache(cache))
    steps, cur = [], jnp.argmax(last, -1)
    for step in range(STEPS):
        dec, cache = jforward_decode(params, jcfg, cur, jnp.int32(S + step),
                                     cache)
        steps.append((np.asarray(cur), np.asarray(dec), _np_cache(cache)))
        cur = jnp.argmax(dec, -1)
    out["decode"] = steps
    prompt = tokens[:, :PROMPT]
    gen = np.asarray(jgenerate(params, jcfg, jnp.asarray(prompt),
                               max_new_tokens=NEW))
    # The logits each generated token was the argmax of, teacher-forced.
    out["gen"] = gen
    out["gen_logits"] = np.asarray(jforward_train(
        params, jcfg, jnp.asarray(gen), remat=False))[:, PROMPT - 1:-1]
    return out


# ---------------------------------------------------------------------------
# layers and cache writes
# ---------------------------------------------------------------------------

def test_norms_rope_and_activations_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(16)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(16)).astype(np.float32)
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6), LAYER_ATOL)
    _close(L.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                        torch.from_numpy(bias)),
           JL.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                         jnp.asarray(bias)), LAYER_ATOL)
    p = jax.tree.map(np.asarray, JL.init_dense(jax.random.key(2), 16, 8))
    p["b"] = (0.1 * rng.standard_normal(8)).astype(np.float32)
    tp = L.init_dense(torch.Generator().manual_seed(0), 16, 8)
    assert tp.w.shape == (16, 8) and float(tp.b.abs().max()) == 0.0
    with torch.no_grad():
        tp.w.copy_(torch.from_numpy(p["w"]))
        tp.b.copy_(torch.from_numpy(p["b"]))
    _close(L.dense(tp, torch.from_numpy(x)),
           JL.dense({k: jnp.asarray(v) for k, v in p.items()},
                    jnp.asarray(x)), LAYER_ATOL)
    pos = np.array([[0, 1, 2, 3, 4], [7, 100, 4095, 4096, 20000]], np.int32)
    for theta in (10_000.0, 1_000_000.0):
        _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            theta),
               JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
               LAYER_ATOL)
    for name in ("silu", "gelu", "relu"):
        _close(L.act_fn(name)(torch.from_numpy(x)),
               JL.act_fn(name)(jnp.asarray(x)), LAYER_ATOL)
    # Up to ~50 in magnitude, where float32's spacing is 3.8e-6: held to a
    # few ulps (the frameworks' tanh differ in the last bits).
    np.testing.assert_allclose(
        L.softcap(torch.from_numpy(x * 80), 50.0).numpy(),
        np.asarray(JL.softcap(jnp.asarray(x * 80), 50.0)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("q_chunk", [0, 4])
@pytest.mark.parametrize("flavor", ["dense-gqa", "gemma-style", "qkv-bias"])
def test_attention_matches_jax(flavor, q_chunk):
    cfg = JLMConfig(**FLAVORS[flavor])
    rng = np.random.default_rng(2)
    p = JL.init_attention(jax.random.key(1), cfg.d_model, cfg.n_heads,
                          cfg.n_kv_heads, cfg.d_head, cfg.qkv_bias)
    p = jax.tree.map(np.asarray, p)
    p = {k: (v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
             if k.startswith("b") else v) for k, v in p.items()}
    tp = L.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                     cfg.qkv_bias, device="cpu")
    with torch.no_grad():
        for k, v in p.items():
            getattr(tp, k).copy_(torch.from_numpy(np.array(v)))
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              d_head=cfg.d_head, rope_theta=cfg.rope_theta,
              attn_softcap=cfg.attn_softcap, q_chunk=q_chunk)
    for window in (0, 5):
        want = JL.attention({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), jnp.asarray(pos),
                            window=jnp.int32(window), **kw)
        got = L.attention(tp, torch.from_numpy(x), torch.from_numpy(pos),
                          window=window, **kw)
        _close(got, want, LAYER_ATOL)


def test_kv_cache_writes_match_jax():
    rng = np.random.default_rng(3)
    B, H, D = 2, 2, 8
    for s_cache, position in ((32, 5), (8, 13), (8, 16)):
        k = rng.standard_normal((B, s_cache, H, D)).astype(np.float32)
        v = rng.standard_normal((B, s_cache, H, D)).astype(np.float32)
        pos = rng.integers(-1, 40, (B, s_cache)).astype(np.int32)
        kn = rng.standard_normal((B, 1, H, D)).astype(np.float32)
        vn = rng.standard_normal((B, 1, H, D)).astype(np.float32)
        want = JKV.write_token(jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos), jnp.asarray(kn),
                               jnp.asarray(vn), jnp.int32(position))
        for p in (position, torch.tensor(position, dtype=torch.int32)):
            got = KV.write_token(torch.from_numpy(k.copy()),
                                 torch.from_numpy(v.copy()),
                                 torch.from_numpy(pos.copy()),
                                 torch.from_numpy(kn), torch.from_numpy(vn),
                                 p)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    seq_k = rng.standard_normal((B, S, H, D)).astype(np.float32)
    seq_v = rng.standard_normal((B, S, H, D)).astype(np.float32)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    for s_cache in (32, S, 8, 5):               # full, exact, two rings
        want = JKV.prefill_write(jnp.asarray(seq_k), jnp.asarray(seq_v),
                                 jnp.asarray(positions), s_cache)
        got = KV.prefill_write(torch.from_numpy(seq_k),
                               torch.from_numpy(seq_v),
                               torch.from_numpy(positions), s_cache)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert KV.decode_slot(13, 8) == 5


# ---------------------------------------------------------------------------
# the decoder's forwards, per flavour
# ---------------------------------------------------------------------------

def test_forward_train_and_hidden_match_jax(run):
    cfg, model = run["cfg"], run["model"]
    _close(forward_train(model, cfg, run["tokens"]), run["train"], FWD_ATOL)
    _close(forward_hidden(model, cfg, run["tokens"]), run["hidden"],
           FWD_ATOL)
    assert torch.equal(forward_train(model, cfg, run["tokens"], remat=False),
                       forward_train(model, cfg, run["tokens"], remat=True))
    chunked = dataclasses.replace(cfg, attn_q_chunk=4)
    _close(forward_train(model, chunked, run["tokens"]), run["train"],
           FWD_ATOL)


def _assert_cache(got, want):
    assert set(got) == set(want)
    for name, (k, v, pos) in want.items():
        _close(got[name].k, k, FWD_ATOL)
        _close(got[name].v, v, FWD_ATOL)
        np.testing.assert_array_equal(got[name].pos.numpy(), pos)


def test_forward_prefill_matches_jax(run):
    cfg, model = run["cfg"], run["model"]
    last, cache = forward_prefill(model, cfg, run["tokens"], MAX_SEQ,
                                  cache_dtype=torch.float32)
    want_last, want_cache = run["prefill"]
    _close(last, want_last, FWD_ATOL)
    _assert_cache(cache, want_cache)
    if cfg.sliding_window:   # the ring holds the window's last positions
        ring = "local" if cfg.local_global_alternating else "all"
        assert cache[ring].pos.shape[1] == cfg.sliding_window


def test_forward_decode_matches_jax_across_the_ring(run):
    """Four decode steps from JAX's tokens (positions 16..19 wrap the
    window-8 rings): logits and the whole cache after each step, and each
    step equals the port's own forward_train on the grown sequence."""
    cfg, model = run["cfg"], run["model"]
    _, cache = forward_prefill(model, cfg, run["tokens"], MAX_SEQ,
                               cache_dtype=torch.float32)
    seq = torch.from_numpy(run["tokens"]).long()
    for step, (cur, want, want_cache) in enumerate(run["decode"]):
        step_fn = forward_decode if step % 2 == 0 else serve_step
        pos = S + step if step < 2 else torch.tensor(S + step)
        dec, cache = step_fn(model, cfg, torch.tensor(cur), pos, cache)
        _close(dec, want, FWD_ATOL)
        _assert_cache(cache, want_cache)
        seq = torch.cat([seq, torch.tensor(cur).long()[:, None]], dim=1)
        _close(dec, forward_train(model, cfg, seq)[:, -1], FWD_ATOL)


def test_generate_matches_jax_where_the_argmax_is_clear(run):
    cfg, model = run["cfg"], run["model"]
    got = generate(model, cfg, torch.from_numpy(run["tokens"][:, :PROMPT]),
                   max_new_tokens=NEW).numpy()
    _assert_generated_like_jax(got, run)


SPREAD = {"1x4": ((1, 4), ["cpu", "cpu", "cpu:0", "cpu:0"]),
          "2x4": ((2, 4), ["cpu", "cpu", "cpu:0", "cpu:0", "cpu:0", "cpu:0",
                           "cpu", "cpu"])}


@pytest.mark.parametrize("layout", list(SPREAD))
def test_prefill_into_a_placed_cache_then_generate_match_jax(run, layout):
    """A cache placed on a mesh spread over two CPU devices (``cpu`` and
    ``cpu:0``): the prefill's blocks gathered equal JAX's prefill cache;
    ``generate`` over it with split-K bound follows JAX's ``generate`` by
    the rule above; unbound (each step gathers the blocks) it equals the
    unplaced ``generate`` bit for bit."""
    cfg, model = run["cfg"], run["model"]
    shape, devices = SPREAD[layout]
    mesh = make_mesh(shape, ("data", "model"), devices=devices)
    _, cache = forward_prefill(model, cfg, run["tokens"], MAX_SEQ,
                               cache_dtype=torch.float32, mesh=mesh)
    _assert_cache({n: KV.CacheStack(*(b.gather() for b in st))
                   for n, st in cache.items()}, run["prefill"][1])
    prompt = torch.from_numpy(run["tokens"][:, :PROMPT])
    FD.configure(mesh, *lm_cache_specs(mesh, 2)["pos"])
    try:
        got = generate(model, cfg, prompt, max_new_tokens=NEW, mesh=mesh)
    finally:
        FD.configure(None, None, None)
    _assert_generated_like_jax(got.numpy(), run)
    assert torch.equal(generate(model, cfg, prompt, max_new_tokens=NEW,
                                mesh=mesh),
                       generate(model, cfg, prompt, max_new_tokens=NEW))


def _assert_generated_like_jax(got, run):
    want, logits = run["gen"], run["gen_logits"]
    assert got.shape == want.shape == (2, PROMPT + NEW)
    np.testing.assert_array_equal(got[:, :PROMPT], want[:, :PROMPT])
    top2 = np.sort(logits, axis=-1)[:, :, -2:]
    gap = top2[:, :, 1] - top2[:, :, 0]                       # (B, NEW)
    checked = 0
    for b in range(want.shape[0]):
        for t in range(NEW):
            if gap[b, t] <= GAP:
                break
            assert got[b, PROMPT + t] == want[b, PROMPT + t], (b, t)
            checked += 1
    assert checked >= 1     # the rule left something to compare


# ---------------------------------------------------------------------------
# configs and conversion
# ---------------------------------------------------------------------------

def _same_config(cfg, jcfg):
    """Equal fields; each shape's ported fields equal, the rest unset."""
    got, want = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
    shapes_g, shapes_w = got.pop("shapes"), want.pop("shapes")
    assert got == want
    assert len(shapes_g) == len(shapes_w)
    for spec_g, spec_w in zip(shapes_g, shapes_w):
        assert all(spec_w[k] == v for k, v in spec_g.items())
        assert not any(v for k, v in spec_w.items() if k not in spec_g)


def test_lm_configs_carry_across_and_the_registry_matches():
    for arch, jcfg in JREGISTRY.items():
        if not isinstance(jcfg, JLMConfig):
            continue
        cfg = LMConfig(**dataclasses.asdict(jcfg))
        _same_config(cfg, jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
    for arch in ("qwen2.5-3b", "internlm2-20b", "gemma2-27b",
                 "mixtral-8x22b", "moonshot-v1-16b-a3b", "colbert-text",
                 "colbert-mm"):
        _same_config(get_config(arch), JREGISTRY[arch])
    with pytest.raises(KeyError, match="unknown arch 'nope'; known: "):
        get_config("nope")
    assert [s.seq_len for s in LM_SHAPES] == [4096, 32768, 32768, 524288]
    assert get_config("qwen2.5-3b").param_count() == 3_397_105_664


def test_conversion_checks_shapes_and_init_is_seeded():
    cfg = LMConfig(**FLAVORS["qkv-bias"])
    params_np = jax.tree.map(np.asarray,
                             jinit_lm(jax.random.key(0),
                                      JLMConfig(**FLAVORS["qkv-bias"])))
    with pytest.raises(ValueError, match="shape"):
        lm_from_jax(params_np, dataclasses.replace(cfg, d_ff=96),
                    device="cpu")
    with pytest.raises(ValueError, match="only one"):
        lm_from_jax(params_np, dataclasses.replace(cfg, qkv_bias=False),
                    device="cpu")
    a, b = (init_lm(cfg, seed=7, device="cpu") for _ in range(2))
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name
    w = a.blocks[0].attn.wq
    assert abs(float(w.std()) - cfg.d_model ** -0.5) < 0.02
    assert float(a.blocks[0].attn.bq.abs().max()) == 0.0
    cache = init_cache(cfg, 2, 10, device="cpu")
    assert cache["all"].k.shape == (2, 2, 10, 2, 16)
    assert int(cache["all"].pos.max()) == -1
