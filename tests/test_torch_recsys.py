"""The port's recsys zoo and the generalized Col-Bandit against the JAX
package, on the CPU.

``models/recsys.py``: the EmbeddingBag substrate (``field_offsets``,
``init_fused_table``'s padding, ``embedding_lookup``, ``embedding_bag``
sum / mean / max with per-row weights and an empty bag), and FM, AutoInt,
DIN and SASRec (each forward, ``*_score_candidates`` with n above the
chunk, so the padded last chunk is exercised, SASRec's user state and
``fm_candidate_components``) at narrow widths, JAX's parameters across
through ``models.convert.recsys_from_jax``; the four configs against
JAX's. Float32 on both sides, sums in different orders: atol 1e-5 (the
card-against-CPU checks use the same bound).

``core/generalized.py``: the component builders, and
``topk_bandit_generalized`` batched and sequential with JAX's key chain
replayed (``JaxReplayDraws``): top-K ids, coverage, reveals and rounds
exact. The sequential loop reveals one cell a round and its hard bounds
sum T support values in the frameworks' different orders (a few ulps
apart), so over ~1,000 rounds a near-tie comparison can go the other way:
at N = 512, T = 16 the first differing reveal is round 130. It is compared
at N = 64, where its runs agree; the batched loop at the benchmark's N =
512.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.configs.base import RecsysConfig as JRecsysConfig
from repro.core import generalized as JG
from repro.models import recsys as JR
from repro_torch.configs import get_config
from repro_torch.configs.base import (RECSYS_SHAPES, RecsysConfig,
                                      criteo_like_vocab)
from repro_torch.core import generalized as G
from repro_torch.core.baselines import exact_topk
from repro_torch.models import recsys as R
from repro_torch.models.convert import recsys_from_jax
from test_torch_core import JaxReplayDraws, key_data
from test_torch_threads import cap_torch_threads

cap_torch_threads()

ATOL = 1e-5
VOCAB = (50, 30, 70, 4097)       # the last field past one pad block
SMALL = {
    "fm": dict(name="fm", interaction="fm-2way", n_sparse=4, embed_dim=6,
               vocab_sizes=VOCAB),
    "autoint": dict(name="autoint", interaction="self-attn", n_sparse=4,
                    embed_dim=8, vocab_sizes=VOCAB, n_attn_layers=2,
                    n_heads=2, d_attn=4),
    "din": dict(name="din", interaction="target-attn", embed_dim=6,
                seq_len=10, item_vocab=300, attn_mlp=(8, 4), mlp=(12, 6)),
    "sasrec": dict(name="sasrec", interaction="self-attn-seq", embed_dim=8,
                   n_blocks=2, n_heads=1, seq_len=10, item_vocab=300),
}
N_CAND, CHUNK = 150, 64


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _t(x):
    return torch.from_numpy(np.array(x))


def _small_model(name):
    jcfg, cfg = JRecsysConfig(**SMALL[name]), RecsysConfig(**SMALL[name])
    p_np = jax.tree.map(np.array,        # writable copies
                        getattr(JR, f"init_{name}")(jax.random.key(1), jcfg))
    # JAX zero-initializes the biases; give them values, so they count.
    rng = np.random.default_rng(1)
    flat = jax.tree_util.tree_flatten_with_path(p_np)[0]
    for path, leaf in flat:
        if path[-1] == jax.tree_util.DictKey("b") or path[-1] == \
                jax.tree_util.DictKey("bias"):
            leaf[...] = 0.1 * rng.standard_normal(leaf.shape)
    return dict(name=name, cfg=cfg, jcfg=jcfg,
                params=jax.tree.map(jnp.asarray, p_np),
                model=recsys_from_jax(p_np, cfg, device="cpu"))


@pytest.fixture(scope="module", params=list(SMALL))
def model(request):
    return _small_model(request.param)


def _field_ids(rng, vocab, n):
    return np.stack([rng.integers(0, v, n) for v in vocab],
                    axis=1).astype(np.int32)


def _history(rng, cfg, n):
    hist = rng.integers(0, cfg.item_vocab, (n, cfg.seq_len)).astype(np.int32)
    lens = rng.integers(0, cfg.seq_len + 1, n)
    lens[0] = 0                                 # an empty history
    mask = np.arange(cfg.seq_len)[None, :] < lens[:, None]
    return hist, mask


def test_forward_matches_jax(model):
    name, cfg, jcfg = model["name"], model["cfg"], model["jcfg"]
    rng = np.random.default_rng(2)
    fwd = getattr(R, f"{name}_forward")
    jfwd = getattr(JR, f"{name}_forward")
    if name in ("fm", "autoint"):
        ids = _field_ids(rng, VOCAB, 9)
        got = fwd(model["model"], cfg, torch.from_numpy(ids))
        want = jfwd(model["params"], jcfg, jnp.asarray(ids))
    else:
        hist, mask = _history(rng, cfg, 9)
        target = rng.integers(0, cfg.item_vocab, 9).astype(np.int32)
        got = fwd(model["model"], cfg, hist, mask, target)
        want = jfwd(model["params"], jcfg, jnp.asarray(hist),
                    jnp.asarray(mask), jnp.asarray(target))
        if name == "sasrec":
            _close(R.sasrec_user_state(model["model"], cfg, hist, mask),
                   JR.sasrec_user_state(model["params"], jcfg,
                                        jnp.asarray(hist),
                                        jnp.asarray(mask)))
    assert got.shape == (9,)
    _close(got, want)


def test_score_candidates_match_jax(model):
    """n = 150 candidates in chunks of 64 (FM takes no chunk)."""
    name, cfg, jcfg = model["name"], model["cfg"], model["jcfg"]
    rng = np.random.default_rng(3)
    score = getattr(R, f"{name}_score_candidates")
    jscore = getattr(JR, f"{name}_score_candidates")
    kw = {} if name in ("fm", "sasrec") else dict(chunk=CHUNK)
    if name in ("fm", "autoint"):
        ctx = _field_ids(rng, VOCAB[:-1], 1)[0]
        cand = rng.integers(0, VOCAB[-1], N_CAND).astype(np.int32)
        args, jargs = (ctx, cand), (jnp.asarray(ctx), jnp.asarray(cand))
    else:
        hist, mask = _history(rng, cfg, 2)
        cand = rng.integers(0, cfg.item_vocab, N_CAND).astype(np.int32)
        args = (hist[1], mask[1], cand)
        jargs = tuple(jnp.asarray(a) for a in args)
    got = score(model["model"], cfg, *args, **kw)
    want = jscore(model["params"], jcfg, *jargs, **kw)
    assert got.shape == (N_CAND,)
    _close(got, want)
    if kw:       # the chunked path equals one unchunked call
        _close(score(model["model"], cfg, *args, chunk=N_CAND), want)
    if name == "fm":
        comps = R.fm_candidate_components(model["model"], cfg, *args)
        _close(comps, JR.fm_candidate_components(model["params"], jcfg,
                                                 *jargs))
        assert comps.shape == (N_CAND, len(VOCAB))
        _close(comps.sum(-1), got)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_jax(mode, weighted):
    rng = np.random.default_rng(4)
    table = rng.standard_normal((40, 5)).astype(np.float32)
    ids = rng.integers(0, 40, 23).astype(np.int32)
    bags = np.sort(rng.choice([0, 1, 3, 4], 23)).astype(np.int32)  # 2: empty
    w = rng.random(23).astype(np.float32) if weighted else None
    got = R.embedding_bag(torch.from_numpy(table), ids, bags, 6,
                          weights=None if w is None else torch.from_numpy(w),
                          mode=mode)
    want = np.asarray(JR.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(bags), 6,
        weights=None if w is None else jnp.asarray(w), mode=mode))
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    _close(got.numpy()[fin], want[fin])
    empty = -np.inf if mode == "max" else 0.0
    for b in (2, 5):
        assert (got[b].numpy() == empty).all()
    with pytest.raises(ValueError):
        R.embedding_bag(torch.from_numpy(table), ids, bags, 6, mode="min")


def test_lookup_offsets_and_fused_table_padding():
    rng = np.random.default_rng(5)
    np.testing.assert_array_equal(R.field_offsets(VOCAB),
                                  JR.field_offsets(VOCAB))
    table = rng.standard_normal((sum(VOCAB), 3)).astype(np.float32)
    ids = _field_ids(rng, VOCAB, 7)
    offs = R.field_offsets(VOCAB)
    np.testing.assert_array_equal(
        R.embedding_lookup(torch.from_numpy(table), torch.from_numpy(ids),
                           offs).numpy(),
        np.asarray(JR.embedding_lookup(jnp.asarray(table), jnp.asarray(ids),
                                       offs)))
    gen = torch.Generator().manual_seed(0)
    for vocab, pad in ((VOCAB, 4096), ((5000, 3000), 4096), ((7, 9), 8)):
        got = R.init_fused_table(gen, vocab, 4, device="cpu",
                                 pad_rows_to=pad)
        want = JR.init_fused_table(jax.random.key(0), vocab, 4,
                                   pad_rows_to=pad)
        assert got.shape == want.shape
        assert got.shape[0] % pad == 0 and got.shape[0] >= sum(vocab)
    assert R.fused_rows(criteo_like_vocab(39)) == 38_563_840
    big = R.init_fused_table(gen, (40_000,), 8, device="cpu")
    assert abs(float(big.std()) - 0.05) < 0.002


def test_recsys_configs_equal_jax():
    for arch in ("fm", "autoint", "din", "sasrec"):
        jcfg = JREGISTRY[arch]
        for cfg in (get_config(arch),
                    RecsysConfig(**dataclasses.asdict(jcfg))):
            got, want = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
            shapes_g, shapes_w = got.pop("shapes"), want.pop("shapes")
            assert got == want
            assert [(s["name"], s["batch"], s["n_candidates"])
                    for s in shapes_g] == \
                [(s["name"], s["batch"], s["n_candidates"])
                 for s in shapes_w]
    assert criteo_like_vocab(39) == JREGISTRY["fm"].vocab_sizes
    assert sum(get_config("autoint").vocab_sizes) == 38_561_881
    assert get_config("fm").vocab_sizes[-1] == 47_886
    assert [s.name for s in RECSYS_SHAPES] == ["train_batch", "serve_p99",
                                               "serve_bulk", "retrieval_cand"]


def test_init_is_seeded_and_conversion_checks_the_tree(model):
    name, cfg = model["name"], model["cfg"]
    init = getattr(R, f"init_{name}")
    a, b = (init(cfg, seed=3, device="cpu") for _ in range(2))
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    assert [n for n, _ in a.named_parameters()] == \
        [n for n, _ in model["model"].named_parameters()]
    for n, x in a.named_parameters():
        assert x.shape == dict(model["model"].named_parameters())[n].shape
    p_np = jax.tree.map(np.asarray, model["params"])
    first = "table" if name in ("fm", "autoint") else "item_table"
    bad = dict(p_np, extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="only one"):
        recsys_from_jax(bad, cfg, device="cpu")
    short = dict(p_np, **{first: p_np[first][:-1]})
    with pytest.raises(ValueError, match="shape"):
        recsys_from_jax(short, cfg, device="cpu")


# ---------------------------------------------------------------------------
# the generalized Col-Bandit
# ---------------------------------------------------------------------------

def _fm_comps(seed, n, n_fields=16, dim=10):
    """``benchmarks/generalized_recsys.py``'s inputs."""
    rng = np.random.default_rng(seed)
    ctx = (rng.standard_normal((n_fields, dim)) * 0.3).astype(np.float32)
    cands = (rng.standard_normal((n, dim)) * 0.3).astype(np.float32)
    return ctx, cands


def test_component_builders_match_jax():
    ctx, cands = _fm_comps(0, 40)
    comps = G.fm_pair_components(_t(ctx), _t(cands))
    _close(comps, JG.fm_pair_components(jnp.asarray(ctx), jnp.asarray(cands)))
    for slack in (0.0, 0.05):
        for got, want in zip(G.component_support(comps, slack),
                             JG.component_support(jnp.asarray(comps.numpy()),
                                                  slack)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(1)
    user = rng.standard_normal(12).astype(np.float32)
    items = rng.standard_normal((40, 12)).astype(np.float32)
    _close(G.dot_components(_t(user), _t(items), 4),
           JG.dot_components(jnp.asarray(user), jnp.asarray(items), 4))
    with pytest.raises(ValueError, match="multiple"):
        G.dot_components(_t(user), _t(items), 5)


def _generalized_pair(comps, seed, **kw):
    want = JG.topk_bandit_generalized(jnp.asarray(comps),
                                      jax.random.key(seed), k=10, **kw)
    got = G.topk_bandit_generalized(_t(comps), key_data(jax.random.key(seed)),
                                    k=10, draws=JaxReplayDraws(), **kw)
    return got, want


@pytest.mark.parametrize("alpha", [0.1, 0.3, 1.0])
def test_generalized_batched_matches_jax(alpha):
    """The benchmark's grid point (N = 512 of its 4,096, block 64 x 2)."""
    ctx, cands = _fm_comps(0, 512)
    comps = np.asarray(JG.fm_pair_components(jnp.asarray(ctx),
                                             jnp.asarray(cands)))
    got, want = _generalized_pair(comps, 0, alpha_ef=alpha, block_docs=64,
                                  block_tokens=2)
    for f in ("topk", "reveals", "rounds", "separated", "revealed"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert float(got.coverage) == float(want.coverage) < 1.0
    exact, _ = exact_topk(_t(comps), k=10)
    assert len(set(got.topk.tolist()) & set(exact.tolist())) >= 8


@pytest.mark.parametrize("seed", [0, 1])
def test_generalized_sequential_matches_jax(seed):
    ctx, cands = _fm_comps(seed, 64)
    comps = np.asarray(JG.fm_pair_components(jnp.asarray(ctx),
                                             jnp.asarray(cands)))
    got, want = _generalized_pair(comps, seed, batched=False,
                                  support_slack=0.01)
    for f in ("topk", "reveals", "rounds", "separated", "revealed"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert float(got.coverage) == float(want.coverage)


def test_generalized_on_fm_candidate_components():
    """FM candidate scoring through the bandit: the components of the
    converted model, default TorchDraws from an int seed, against exact
    top-K."""
    model = _small_model("fm")
    rng = np.random.default_rng(6)
    ctx = _field_ids(rng, VOCAB[:-1], 1)[0]
    cand = rng.integers(0, VOCAB[-1], 400)
    comps = R.fm_candidate_components(model["model"], model["cfg"], ctx,
                                      cand)
    res = G.topk_bandit_generalized(comps, 0, k=10, block_docs=64,
                                    block_tokens=1)
    again = G.topk_bandit_generalized(comps, 0, k=10, block_docs=64,
                                      block_tokens=1)
    assert torch.equal(res.revealed, again.revealed)
    exact, _ = exact_topk(comps, k=10)
    assert res.topk.shape == (10,) and 0.0 < float(res.coverage) <= 1.0
    assert len(set(res.topk.tolist()) & set(exact.tolist())) >= 8
