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

The placed cache (one block per shard, on the shard's device) is tested
over meshes spread across two CPU devices, ``cpu`` and ``cpu:0`` (distinct
torch devices: a move between them is a copy): which block each device
holds and its bytes, exactly; a decode write lands only in the blocks that
own its slot (a ring wrap across blocks, a block held on both devices) and
equals JAX's ``write_token`` on the global array bit for bit; split-K over
the blocks is held to JAX's vmapped combine within 1e-6 and reports the
same all-reduce bytes; ``forward_decode`` over blocks to JAX's decode
within 1e-4; on a mesh whose shards share one device, the placed path
equals the unplaced one bit for bit, bound or not.
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
from repro.models import kv_cache as JKV
from repro_torch.analysis.audit import Recorder
from repro_torch.configs.base import LMConfig
from repro_torch.dist import flash_decode as FD
from repro_torch.dist.mesh import make_mesh, place_blocks
from repro_torch.dist.sharding import lm_cache_specs
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


def test_configure_rejects_an_axis_the_mesh_lacks():
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


# ---------------------------------------------------------------------------
# the placed cache: one block per shard, on the shard's device
# ---------------------------------------------------------------------------

C, C0 = torch.device("cpu"), torch.device("cpu", 0)
SPREAD = {          # name: (mesh shape, devices, batch)
    "1x4": ((1, 4), [C, C, C0, C0], 2),
    "2x4": ((2, 4), [C, C, C0, C0, C0, C0, C, C], 2),
    "2x4-replicated": ((2, 4), [C] * 4 + [C0] * 4, 1),
    "1x4-alternating": ((1, 4), [C, C0, C, C0], 2),
}


def _spread(name):
    shape, devices, batch = SPREAD[name]
    return make_mesh(shape, ("data", "model"), devices=devices), batch


def _held(mesh, batch):
    """Per device, the (batch block, sequence block) pairs its shards own,
    worked out from the mesh by hand: shard s = (d, m) row-major; the batch
    splits over "data" where it divides, the sequence over "model"."""
    nd = mesh.shape["data"]
    held = {}
    for s, dev in enumerate(mesh.devices):
        d, m = divmod(s, mesh.shape["model"])
        held.setdefault(dev, set()).add((d if batch % nd == 0 and batch > 1
                                         else 0, m))
    return held


@pytest.mark.parametrize("layout", list(SPREAD))
def test_placed_stack_holds_each_block_on_its_shards_device(layout):
    mesh, batch = _spread(layout)
    n, S_, H, D = 3, 16, 2, 8
    st = KV.init_stack(n, batch, S_, H, D, torch.float32, mesh=mesh)
    held = _held(mesh, batch)
    nb = mesh.shape["data"] if batch > 1 else 1
    b, s = batch // nb, S_ // 4
    for name, per_block in (("k", n * b * s * H * D * 4),
                            ("v", n * b * s * H * D * 4),
                            ("pos", b * s * 4)):
        blocks = getattr(st, name)
        assert blocks.bytes_by_device() == {
            dev: len(pairs) * per_block for dev, pairs in held.items()}
        lead = 1 if name != "pos" else 0
        for sh, part in enumerate(blocks.parts):
            d, m = divmod(sh, 4)
            i = d if nb > 1 else 0
            assert blocks.starts[sh][lead:lead + 2] == (i * b, m * s)
            assert tuple(part.shape)[lead:lead + 2] == (b, s)
            fill = -1 if name == "pos" else 0
            assert bool((part == fill).all())
        # no storage is shared across devices; a device whose blocks tile
        # one box holds one copy, else one a run of consecutive shards
        # whose blocks tile (2x4: rows 0 and 1 own diagonal pairs), else
        # one a block (alternating)
        stores = {}
        for sh, part in enumerate(blocks.parts):
            stores.setdefault(mesh.devices[sh], set()).add(
                part.untyped_storage().data_ptr())
        assert not set.intersection(*stores.values())
        want = 2 if layout in ("2x4", "1x4-alternating") else 1
        assert all(len(v) == want for v in stores.values())


def test_place_blocks_gather_and_one_device_views():
    x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    for layout in SPREAD:
        mesh, _ = _spread(layout)
        bl = place_blocks(x, mesh, ("data", "model"))
        assert bl.whole is None
        for sh, part in enumerate(bl.parts):
            assert torch.equal(part, x[bl.region(sh)])
        assert torch.equal(bl.gather(), x)
    one = place_blocks(x, make_mesh((2, 4), ("data", "model"), device="cpu"),
                       ("data", "model"))
    assert one.whole is x                      # one device: views of x
    assert all(p.data_ptr() == x[r].data_ptr()
               for p, r in zip(one.parts, map(one.region, range(8))))
    with pytest.raises(ValueError, match="does not split"):
        place_blocks(torch.zeros(2, 6), _spread("1x4")[0], (None, "model"))


def _filled(mesh, batch, s_cache, rng, n=2, H=2, D=4):
    k = rng.standard_normal((n, batch, s_cache, H, D)).astype(np.float32)
    v = rng.standard_normal((n, batch, s_cache, H, D)).astype(np.float32)
    pos = rng.integers(-1, 40, (batch, s_cache)).astype(np.int32)
    st = KV.init_stack(n, batch, s_cache, H, D, torch.float32, mesh=mesh)
    for blocks, a in zip(st, (k, v, pos)):
        blocks.copy_(torch.from_numpy(a))
    return st, (k, v, pos)


@pytest.mark.parametrize("layout", ["1x4", "2x4", "2x4-replicated"])
def test_write_token_lands_only_in_the_owning_block(layout):
    """A ring of 8 slots in 4 blocks of 2: positions 13, 14 and 16 write
    slots 5, 6 and 0 (the wrap back to block 0), into layer 1 of 2. Each
    write equals JAX's on the global array; every other block, and layer 0,
    keeps its bytes."""
    mesh, batch = _spread(layout)
    rng = np.random.default_rng(7)
    st, (k, v, pos) = _filled(mesh, batch, 8, rng)
    for position in (13, 14, 16):
        kn = rng.standard_normal((batch, 1, 2, 4)).astype(np.float32)
        vn = rng.standard_normal((batch, 1, 2, 4)).astype(np.float32)
        before = [tuple(p.clone() for p in b.parts) for b in st]
        got = KV.write_token(st.k[1], st.v[1], st.pos,
                             torch.from_numpy(kn), torch.from_numpy(vn),
                             position)
        want = JKV.write_token(jnp.asarray(k[1]), jnp.asarray(v[1]),
                               jnp.asarray(pos), jnp.asarray(kn),
                               jnp.asarray(vn), jnp.int32(position))
        k[1], v[1], pos = (np.asarray(w) for w in want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.gather().numpy(), np.asarray(w))
        slot, new = position % 8, (kn, vn, None)
        for blocks, old, tok in zip(st, before, new):
            lead = 0 if tok is None else 1
            for sh, (part, was) in enumerate(zip(blocks.parts, old)):
                rows, cols = blocks.region(sh)[lead:lead + 2]
                want_part = was.clone()
                if cols.start <= slot < cols.stop:    # the owning block
                    at = slot - cols.start
                    if tok is None:
                        want_part[:, at] = position
                    else:                             # layer 1 alone
                        want_part[1, :, at] = torch.from_numpy(
                            tok[rows, 0])
                assert torch.equal(part, want_part), (layout, position, sh)
        for blocks, a in zip(st, (k, v, pos)):
            np.testing.assert_array_equal(blocks.gather().numpy(), a)


def _placed_args(args, mesh, batch_part):
    """(qg, k, v, kv_pos, q_pos) with k / v / kv_pos placed on ``mesh``."""
    qg, k, v, kv_pos, _, q_pos = (torch.from_numpy(np.ascontiguousarray(a))
                                  for a in args)
    spec = (batch_part, "model")
    return (qg, place_blocks(k, mesh, spec), place_blocks(v, mesh, spec),
            place_blocks(kv_pos, mesh, spec), q_pos)


@pytest.mark.parametrize("window,cap", CASES)
@pytest.mark.parametrize("layout", ["1x4", "2x4", "1x4-alternating",
                                    "2x4-replicated"])
def test_split_k_over_blocks_matches_jax_split_k_arithmetic(layout, window,
                                                            cap):
    """Each shard's partials on its own device, the combine on the batch
    block's merge device: batch block i equals JAX's vmapped combine over
    its 4 sequence slices, and the audit sees the same all-reduce bytes as
    the unplaced path."""
    mesh, _ = _spread(layout)
    qg, k, v, kv_pos, _, q_pos = _inputs(4)
    kv_pos = kv_pos.copy()
    kv_pos[1, 30:] = -1
    q_pos = np.array([[49], [29]], np.int32)
    args = (qg, k, v, kv_pos, kv_pos >= 0, q_pos)
    bp = "data" if layout.startswith("2x4") and "replicated" not in layout \
        else None
    qg_t, kb, vb, pb, qp = _placed_args(args, mesh, bp)
    with bound(mesh, bp, "model"), Recorder() as rec:
        got = FD.flash_decode_attention(qg_t, kb, vb, pb, None, qp, window,
                                        1.0 / DH ** 0.5, cap).numpy()
    with bound(make_mesh(mesh.shape.values(), ("data", "model"),
                         device="cpu"), bp, "model"), Recorder() as ref:
        _port(args, window, cap)
    assert rec.collective == ref.collective
    nb = 2 if bp else 1
    assert rec.collective["all-reduce"] == 4 * B * HKV * G * (2 + DH) * 4
    for i in range(nb):
        rows = slice(i * (B // nb), (i + 1) * (B // nb))
        blk = [a[rows] for a in args]
        np.testing.assert_allclose(got[rows], _jax_split(blk, window, cap, 4),
                                   rtol=0, atol=SPLIT_ATOL)
    # a placed cache does not attend unbound, nor on another mesh
    with pytest.raises(ValueError, match="configure"):
        FD.flash_decode_attention(qg_t, kb, vb, pb, None, qp, window, 1.0)
    with bound(make_mesh((1, 4), ("data", "model"), device="cpu"), None,
               "model"), pytest.raises(ValueError, match="placed on"):
        FD.flash_decode_attention(qg_t, kb, vb, pb, None, qp, window, 1.0)


@pytest.mark.parametrize("window,cap", CASES)
def test_split_k_over_one_device_blocks_is_the_view_path_bit_for_bit(window,
                                                                     cap):
    args = _inputs(5)
    for shape, bp in (((1, 4), None), ((2, 4), "data")):
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        with bound(mesh, bp, "model"):
            want = _port(args, window, cap)
            qg, kb, vb, pb, qp = _placed_args(args, mesh, bp)
            assert kb.whole is not None
            got = FD.flash_decode_attention(qg, kb, vb, pb, None, qp,
                                            window, 1.0 / DH ** 0.5,
                                            cap).numpy()
        np.testing.assert_array_equal(got, want)


def _placed_cache(cache_np, mesh):
    """JAX's prefill cache, copied into a cache placed on ``mesh``."""
    out = {}
    for name, (k, v, pos) in cache_np.items():
        n, b, s, h, d = k.shape
        st = KV.init_stack(n, b, s, h, d, torch.float32, mesh=mesh)
        for blocks, a in zip(st, (k, v, pos)):
            blocks.copy_(torch.from_numpy(np.array(a)))
        out[name] = st
    return out


def _decode_placed(run, mesh, split_k=True):
    cache = _placed_cache(run["cache0"], mesh)
    spec = lm_cache_specs(mesh, 2)["pos"]
    out = []
    with torch.no_grad(), (bound(mesh, *spec) if split_k
                           else contextlib.nullcontext()):
        for step, (cur, _) in enumerate(run["steps"]):
            logits, cache = T.forward_decode(
                run["model"], run["cfg"], torch.from_numpy(np.array(cur)),
                PROMPT + step if step % 2 else torch.tensor(PROMPT + step),
                cache)
            out.append(logits.numpy())
    return out, cache


@pytest.mark.parametrize("layout", ["1x4", "2x4"])
def test_forward_decode_over_placed_blocks_matches_jax(run, layout):
    """Four split-K steps over a cache whose blocks sit on two devices
    (gemma2's 8-slot rings wrap across their 2-slot blocks)."""
    mesh, _ = _spread(layout)
    got, cache = _decode_placed(run, mesh)
    for step, (g, (_, want)) in enumerate(zip(got, run["steps"])):
        np.testing.assert_allclose(g, want, rtol=0, atol=DEC_ATOL,
                                   err_msg=f"{run['name']} step {step}")
    # the blocks on each device hold exactly their share of every stack
    for st in cache.values():
        share = st.k.bytes_by_device()
        assert set(share) == {C, C0}
        assert sum(share.values()) == st.k.gather().numel() * 4


def test_one_device_placed_decode_equals_unplaced_bit_for_bit(run):
    """On a mesh whose shards share one device the placed cache is views
    of one copy: split-K bound or not, logits and cache equal the unplaced
    path's bit for bit (unbound, the blocks gather to that copy)."""
    for shape, bp in (((1, 4), None), ((2, 4), "data")):
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        with bound(mesh, bp, "model"):
            want = _decode(run)
        got, cache = _decode_placed(run, mesh)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    got, cache = _decode_placed(run, mesh, split_k=False)
    for g, w in zip(got, _decode(run)):
        np.testing.assert_array_equal(g, w)
    assert all(st.k.whole is not None for st in cache.values())
