"""The port's split-K decode (``repro_torch.dist.flash_decode``) against the
JAX package's, on the CPU, in one process.

``flash_decode_attention`` on CPU meshes of S = 1, 2, 4 and 8 sequence
shards is held to JAX's ``_local_attention(..., seq_axes=())`` within atol
1e-5 (JAX's own bound, ``tests/test_flash_decode.py``), on JAX's test
shapes (B 2, S 64, Hkv 2, G 3, Dh 8, slots 50..63 empty, window 0 / 16,
softcap 50 / None: at S = 8 the last shard is all empty, and with window
16 the first shards are all outside it). JAX's split-K arithmetic itself
runs as ``_local_attention`` under ``jax.vmap(..., axis_name="model")``
over the stacked sequence slices, which binds its ``pmax`` / ``psum`` in
one process; the port is held to it within 1e-6 (the same float32 terms,
summed in the two frameworks' orders). A (2, 4) ("data", "model") mesh
holds batch block i to JAX's vmapped combine over block i's 4 slices.

``forward_decode`` with the path bound is held to JAX's ``forward_decode``
with it unbound within atol 1e-4 (JAX's bound), four steps from a JAX
prefill, on the four dense flavours of ``tests/test_torch_lm.py`` (gemma2's
ring caches wrap during the steps; Qwen's QKV bias) and the MoE flavour
of ``tests/test_torch_moe.py``. Unbound, the port's decode is unchanged
bit for bit (held to the decode loop as it was before the branch).
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LMConfig as JLMConfig
from repro.dist import flash_decode as JFD
from repro.models.transformer import forward_decode as jforward_decode
from repro.models.transformer import forward_prefill as jforward_prefill
from repro.models.transformer import init_lm as jinit_lm
from repro_torch.configs.base import LMConfig
from repro_torch.dist import flash_decode as FD
from repro_torch.dist.mesh import make_mesh
from repro_torch.models import kv_cache as KV
from repro_torch.models import transformer as T
from repro_torch.models.convert import lm_from_jax
from repro_torch.models.layers import apply_rope, attention, rms_norm
from test_torch_lm import FLAVORS as DENSE
from test_torch_moe import MOE
from test_torch_threads import cap_torch_threads

cap_torch_threads()

pytestmark = pytest.mark.timeout(300)

ATOL, DEC_ATOL, SPLIT_ATOL = 1e-5, 1e-4, 1e-6
B, S, HKV, G, DH = 2, 64, 2, 3, 8
FLAVORS = dict(DENSE, moe=MOE)
PROMPT, MAX_SEQ, STEPS = 16, 32, 4


@contextlib.contextmanager
def bound(mesh, batch_part, seq_part):
    FD.configure(mesh, batch_part, seq_part)
    try:
        yield
    finally:
        FD.configure(None, None, None)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    qg = rng.standard_normal((B, 1, HKV, G, DH)).astype(np.float32)
    k = rng.standard_normal((B, S, HKV, DH)).astype(np.float32)
    v = rng.standard_normal((B, S, HKV, DH)).astype(np.float32)
    kv_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    kv_pos = np.where(kv_pos < 50, kv_pos, -1).astype(np.int32)
    kv_valid = kv_pos >= 0
    q_pos = np.full((B, 1), 49, np.int32)
    return qg, k, v, kv_pos, kv_valid, q_pos


def _port(args, window, cap):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    return FD.flash_decode_attention(*t, window, 1.0 / DH ** 0.5,
                                     cap).numpy()


def _jax_split(args, window, cap, n):
    """JAX's split-K combine over n sequence slices: ``_local_attention``
    with ``seq_axes=("model",)`` under ``jax.vmap(axis_name="model")``."""
    qg, k, v, kv_pos, kv_valid, q_pos = args

    def stack(a):
        return jnp.stack(jnp.split(jnp.asarray(a), n, axis=1))

    kernel = functools.partial(JFD._local_attention, scale=1.0 / DH ** 0.5,
                               softcap=cap, seq_axes=("model",))
    out = jax.vmap(kernel, in_axes=(None, 0, 0, 0, 0, None, None),
                   axis_name="model")(
        jnp.asarray(qg), stack(k), stack(v), stack(kv_pos), stack(kv_valid),
        jnp.asarray(q_pos), jnp.int32(window))
    out = np.asarray(out)
    for s in range(1, n):                      # every shard holds the result
        np.testing.assert_array_equal(out[s], out[0])
    return out[0]


CASES = [(0, 50.0), (16, None)]


@pytest.mark.parametrize("window,cap", CASES)
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_split_k_matches_jax_local_attention(n, window, cap):
    args = _inputs()
    ref = np.asarray(JFD._local_attention(
        *[jnp.asarray(a) for a in args], jnp.int32(window),
        scale=1.0 / DH ** 0.5, softcap=cap, seq_axes=()))
    with bound(make_mesh((n,), ("model",), device="cpu"), None, "model"):
        got = _port(args, window, cap)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    # an all-masked shard (n = 8: slots 56..63 empty; window 16: the first
    # shards lie outside it) contributes nothing and stays finite
    assert np.isfinite(got).all()


@pytest.mark.parametrize("window,cap", CASES)
@pytest.mark.parametrize("n", [2, 4, 8])
def test_split_k_matches_jax_split_k_arithmetic(n, window, cap):
    args = _inputs(1)
    with bound(make_mesh((n,), ("model",), device="cpu"), None, "model"):
        got = _port(args, window, cap)
    np.testing.assert_allclose(got, _jax_split(args, window, cap, n),
                               rtol=0, atol=SPLIT_ATOL)


@pytest.mark.parametrize("window,cap", CASES)
def test_batch_blocks_combine_only_their_own_shards(window, cap):
    """(2, 4) mesh, batch over "data", sequence over "model": batch block i
    is JAX's combine over block i's 4 slices alone."""
    qg, k, v, kv_pos, _, q_pos = _inputs(2)
    kv_pos = kv_pos.copy()
    kv_pos[1, 30:] = -1              # the blocks see different valid slots
    q_pos = np.array([[49], [29]], np.int32)
    args = (qg, k, v, kv_pos, kv_pos >= 0, q_pos)
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    with bound(mesh, "data", "model"):
        got = _port(args, window, cap)
    for i in range(2):
        blk = [a[i:i + 1] for a in args]
        np.testing.assert_allclose(got[i:i + 1],
                                   _jax_split(blk, window, cap, 4),
                                   rtol=0, atol=SPLIT_ATOL)


def test_unbound_path_is_local_attention():
    args = _inputs(3)
    ref = np.asarray(JFD._local_attention(
        *[jnp.asarray(a) for a in args], jnp.int32(16),
        scale=1.0 / DH ** 0.5, softcap=None, seq_axes=()))
    assert not FD.enabled()
    np.testing.assert_allclose(_port(args, 16, None), ref, rtol=0,
                               atol=ATOL)


def test_configure_rejects_a_mesh_of_several_devices():
    mesh = make_mesh((2,), ("model",), devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="per-card KV-cache blocks"):
        FD.configure(mesh, None, "model")
    assert not FD.enabled()
    with pytest.raises(ValueError, match="not in the mesh"):
        FD.configure(make_mesh((2,), ("model",), device="cpu"), "data",
                     "model")
    assert not FD.enabled()


# ---------------------------------------------------------------------------
# forward_decode
# ---------------------------------------------------------------------------

def _torch_cache(cache_np):
    return {name: KV.CacheStack(*(torch.from_numpy(np.array(a))
                                  for a in st))
            for name, st in cache_np.items()}


@pytest.fixture(scope="module", params=list(FLAVORS))
def run(request):
    """One flavour: JAX's prefill and four decode steps (path unbound), and
    the port's converted model."""
    name = request.param
    jcfg, cfg = JLMConfig(**FLAVORS[name]), LMConfig(**FLAVORS[name])
    rng = np.random.default_rng(0)
    params_np = jax.tree.map(np.asarray, jinit_lm(jax.random.key(0), jcfg))
    for stack in ("all", "local", "global"):
        attn = params_np.get(stack, {}).get("attn", {})
        for b in ("bq", "bk", "bv"):
            if b in attn:
                attn[b] = (0.1 * rng.standard_normal(attn[b].shape)
                           ).astype(np.float32)
    params = jax.tree.map(jnp.asarray, params_np)
    tokens = rng.integers(0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    last, cache = jforward_prefill(params, jcfg, tokens, max_seq=MAX_SEQ,
                                   cache_dtype=jnp.float32)
    cache0 = {n: tuple(np.asarray(a) for a in st) for n, st in cache.items()}
    steps, cur = [], jnp.argmax(last, -1)
    for step in range(STEPS):
        dec, cache = jforward_decode(params, jcfg, cur,
                                     jnp.int32(PROMPT + step), cache)
        steps.append((np.asarray(cur), np.asarray(dec)))
        cur = jnp.argmax(dec, -1)
    return dict(name=name, cfg=cfg, cache0=cache0, steps=steps,
                model=lm_from_jax(params_np, cfg, device="cpu"))


def _decode(run, decode=T.forward_decode):
    cache = _torch_cache(run["cache0"])
    out = []
    with torch.no_grad():
        for step, (cur, _) in enumerate(run["steps"]):
            logits, cache = decode(run["model"], run["cfg"],
                                   torch.from_numpy(np.array(cur)),
                                   PROMPT + step, cache)
            out.append(logits.numpy())
    return out


@pytest.mark.parametrize("shape,batch_part",
                         [((1, 4), None), ((2, 4), "data")])
def test_forward_decode_with_split_k_matches_jax(run, shape, batch_part):
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    with bound(mesh, batch_part, "model"):
        got = _decode(run)
    for step, (g, (_, want)) in enumerate(zip(got, run["steps"])):
        np.testing.assert_allclose(g, want, rtol=0, atol=DEC_ATOL,
                                   err_msg=f"{run['name']} step {step}")


def _decode_before_the_branch(params, cfg, token, position, cache):
    """``forward_decode`` as it was before the split-K branch."""
    token = T._token_ids(params, token)
    Bt = token.shape[0]
    x = params.embed[token][:, None, :]
    position = KV.position_tensor(position, token.device)
    positions = position.to(torch.int32).reshape(1, 1).expand(Bt, 1)
    for blk, stack, idx, window in T._plan(params, cfg):
        st = cache[stack]
        k_l, v_l = st.k[idx], st.v[idx]
        h = rms_norm(x, blk.ln1, cfg.norm_eps)
        k_new = h @ blk.attn.wk
        v_new = h @ blk.attn.wv
        if blk.attn.bk is not None:
            k_new = k_new + blk.attn.bk
            v_new = v_new + blk.attn.bv
        k_new = k_new.reshape(Bt, 1, cfg.n_kv_heads, cfg.d_head)
        v_new = v_new.reshape(Bt, 1, cfg.n_kv_heads, cfg.d_head)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
        k_upd, v_upd, pos_upd = KV.write_token(
            k_l, v_l, st.pos, k_new.to(k_l.dtype), v_new.to(v_l.dtype),
            position)
        x = x + attention(
            blk.attn, h, positions, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
            rope_theta=cfg.rope_theta, window=window,
            attn_softcap=cfg.attn_softcap,
            kv_override=(k_upd, v_upd, pos_upd, pos_upd >= 0))
        h2 = rms_norm(x, blk.ln2, cfg.norm_eps)
        x = x + T._ffn(blk, h2, cfg, no_drop=True)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return T.softcap(x[:, 0] @ params.head, cfg.logit_softcap), cache


def test_unbound_decode_is_unchanged_bit_for_bit(run):
    assert not FD.enabled()
    for g, w in zip(_decode(run), _decode(run, _decode_before_the_branch)):
        np.testing.assert_array_equal(g, w)
