"""The late-interaction encoder and the slice as a whole (tokens in,
Col-Bandit's top-K out) against the JAX package, on the CPU.

``encode_tokens``: the same numpy token ids and mask through JAX's encoder
and the port's (parameters across through ``models.convert``), equal within
atol 1e-5 (unit-norm rows, float32, sums in different orders), masked rows
exactly 0 in both; as in JAX, masked tokens still take part in attention.

The slice: tokens -> each package's encoder -> each package's
``serve_queries`` (JAX on its plain lane, ``REPRO_KERNEL_IMPL=ref``). The
two sides' embeddings differ in the last bits, so a dense top-5 may differ
where two scores tie to that noise. The rule: a query's top-5 id set must
equal JAX's wherever JAX's 5th and 6th dense scores differ by more than
1e-4. The bandit then runs on the port's embeddings through both pipelines
(JAX's key chain replayed by ``JaxReplayDraws``): ids, reveal fractions,
rounds and lockstep waste exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import BanditConfig as JBanditConfig
from repro.configs.base import LMConfig as JLMConfig
from repro.models.colbert import encode_tokens as jencode
from repro.models.colbert import init_li_head as jinit_li_head
from repro.models.transformer import init_lm as jinit_lm
from repro.retrieval.index import build_index as j_build_index
from repro.retrieval.pipeline import serve_queries as j_serve
from repro_torch.configs.base import BanditConfig, LMConfig
from repro_torch.models.colbert import LIHead, encode_tokens, init_li_head
from repro_torch.models.convert import li_head_from_jax, lm_from_jax
from repro_torch.models.transformer import init_lm
from repro_torch.retrieval.index import from_numpy
from repro_torch.retrieval.pipeline import serve_queries
from test_torch_core import JaxReplayDraws
from test_torch_threads import cap_torch_threads

cap_torch_threads()

ATOL, GAP = 1e-5, 1e-4
BACKBONES = {
    "qkv-bias": dict(name="q", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
                     qkv_bias=True, li_dim=32),
    "gemma-style": dict(name="g", n_layers=2, d_model=64, n_heads=4,
                        n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
                        sliding_window=8, local_global_alternating=True,
                        attn_softcap=50.0, logit_softcap=30.0, act="gelu",
                        li_dim=32),
}
N_DOCS, L, N_Q, T = 48, 24, 4, 8
SERVE = dict(k=5, max_candidates=32, kprime=10)


def _models(name):
    """JAX parameters (numpy) and the port's converted models."""
    jcfg, cfg = JLMConfig(**BACKBONES[name]), LMConfig(**BACKBONES[name])
    k_lm, k_head = jax.random.split(jax.random.key(3))
    lm_np = jax.tree.map(np.asarray, jinit_lm(k_lm, jcfg))
    head_np = jax.tree.map(np.asarray, jinit_li_head(k_head, jcfg))
    return (jcfg, lm_np, head_np, cfg,
            lm_from_jax(lm_np, cfg, device="cpu"),
            li_head_from_jax(head_np, cfg, device="cpu"))


def _tokens(vocab, seed=0):
    """Docs of random ids, lengths 3..L, padded to L; queries of T ids."""
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, vocab, (N_DOCS, L)).astype(np.int32)
    lens = rng.integers(3, L + 1, N_DOCS)
    mask = np.arange(L)[None, :] < lens[:, None]
    docs[~mask] = 0
    queries = rng.integers(0, vocab, (N_Q, T)).astype(np.int32)
    return docs, mask, lens, queries


@pytest.fixture(scope="module", params=list(BACKBONES))
def encoded(request):
    jcfg, lm_np, head_np, cfg, lm, head = _models(request.param)
    docs, mask, lens, queries = _tokens(cfg.vocab)
    jlm = jax.tree.map(jnp.asarray, lm_np)
    jhead = jax.tree.map(jnp.asarray, head_np)
    qmask = np.ones(queries.shape, bool)
    j_docs = np.asarray(jencode(jlm, jhead, jcfg, jnp.asarray(docs),
                                jnp.asarray(mask))[0])
    j_q = np.asarray(jencode(jlm, jhead, jcfg, jnp.asarray(queries),
                             jnp.asarray(qmask))[0])
    t_docs, t_mask = encode_tokens(lm, head, cfg, torch.from_numpy(docs),
                                   torch.from_numpy(mask))
    t_q, _ = encode_tokens(lm, head, cfg, torch.from_numpy(queries),
                           torch.from_numpy(qmask))
    return dict(cfg=cfg, mask=mask, lens=lens, j_docs=j_docs, j_q=j_q,
                t_docs=t_docs.numpy(), t_q=t_q.numpy(), t_mask=t_mask)


def test_encode_tokens_matches_jax(encoded):
    np.testing.assert_allclose(encoded["t_docs"], encoded["j_docs"], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(encoded["t_q"], encoded["j_q"], rtol=0,
                               atol=ATOL)
    mask = encoded["mask"]
    assert (encoded["t_docs"][~mask] == 0).all()
    assert (encoded["j_docs"][~mask] == 0).all()
    norms = np.linalg.norm(encoded["t_docs"][mask], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
    assert torch.equal(encoded["t_mask"], torch.from_numpy(mask))


def test_masked_tokens_take_part_in_attention_as_in_jax():
    """Masked tokens are zeroed on output only. Padding on the right cannot
    reach a valid row (attention is causal), so another pad id leaves every
    row as it was; a masked token inside a doc is still attended to by the
    valid tokens after it, in both packages."""
    jcfg, lm_np, head_np, cfg, lm, head = _models("qkv-bias")
    docs, mask, _, _ = _tokens(cfg.vocab, seed=1)
    other = docs.copy()
    other[~mask] = 7
    assert torch.equal(encode_tokens(lm, head, cfg, docs, mask)[0],
                       encode_tokens(lm, head, cfg, other, mask)[0])
    holes = mask.copy()
    holes[:, 1] = False                  # a hole before valid tokens
    other = docs.copy()
    other[:, 1] = (docs[:, 1] + 1) % cfg.vocab
    a = encode_tokens(lm, head, cfg, docs, holes)[0]
    b = encode_tokens(lm, head, cfg, other, holes)[0]
    assert (b[:, 1] == 0).all()
    assert not torch.equal(a[:, 2:], b[:, 2:])
    jlm = jax.tree.map(jnp.asarray, lm_np)
    jhead = jax.tree.map(jnp.asarray, head_np)
    jb = np.asarray(jencode(jlm, jhead, jcfg, jnp.asarray(other),
                            jnp.asarray(holes))[0])
    np.testing.assert_allclose(b.numpy(), jb, rtol=0, atol=ATOL)


def _jax_serve(embs, mask, lens, queries, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_KERNEL_IMPL", "ref")
        idx = j_build_index(embs, mask, lens)
        return j_serve(idx, queries, seed=0, bandit=JBanditConfig(k=5),
                       **{**SERVE, **kw})


def _port_serve(embs, mask, lens, queries, **kw):
    idx = from_numpy(embs, mask, lens, device="cpu")
    return serve_queries(idx, queries, seed=0, device="cpu",
                         bandit=BanditConfig(k=5), draws=JaxReplayDraws(),
                         **{**SERVE, **kw})


def test_tokens_to_dense_top5_match_jax(encoded):
    mask, lens = encoded["mask"], encoded["lens"]
    want = _jax_serve(encoded["j_docs"], mask, lens, encoded["j_q"],
                      flavor="dense")
    six = _jax_serve(encoded["j_docs"], mask, lens, encoded["j_q"],
                     flavor="dense", k=6)
    got = _port_serve(encoded["t_docs"], mask, lens, encoded["t_q"],
                      flavor="dense")
    np.testing.assert_array_equal(six.topk_ids[:, :5], want.topk_ids)
    gap = six.topk_scores[:, 4] - six.topk_scores[:, 5]
    clear = gap > GAP
    assert clear.any()
    for q in np.flatnonzero(clear):
        assert set(got.topk_ids[q]) == set(want.topk_ids[q]), q
    np.testing.assert_allclose(got.topk_scores[clear],
                               want.topk_scores[clear], rtol=0, atol=1e-4)


@pytest.mark.parametrize("engine", ["pooled_fused", "pooled_chain"])
def test_bandit_on_the_port_embeddings_matches_jax(encoded, engine):
    args = (encoded["t_docs"], encoded["mask"], encoded["lens"],
            encoded["t_q"])
    want = _jax_serve(*args, flavor="bandit", engine=engine)
    got = _port_serve(*args, flavor="bandit", engine=engine)
    np.testing.assert_array_equal(got.topk_ids, want.topk_ids)
    np.testing.assert_array_equal(got.reveal_fraction, want.reveal_fraction)
    np.testing.assert_array_equal(got.stats[1:3], want.stats[1:3])
    assert got.stats[1] > 0


def test_li_head_init_and_conversion():
    cfg = LMConfig(**BACKBONES["qkv-bias"])
    a = init_li_head(cfg, seed=4, device="cpu")
    b = init_li_head(cfg, seed=4, device="cpu")
    assert isinstance(a, LIHead) and a.proj.shape == (64, 32)
    assert torch.equal(a.proj, b.proj)
    assert abs(float(a.proj.std()) - 64 ** -0.5) < 0.03
    with pytest.raises(ValueError, match="shape"):
        li_head_from_jax({"proj": np.zeros((64, 16), np.float32)}, cfg,
                         device="cpu")
    lm = init_lm(dataclasses.replace(cfg, n_layers=1), seed=4, device="cpu")
    emb, m = encode_tokens(lm, a, lm.cfg, np.zeros((2, 5), np.int32),
                           np.ones((2, 5), bool))
    assert emb.shape == (2, 5, 32) and m.dtype == torch.bool
