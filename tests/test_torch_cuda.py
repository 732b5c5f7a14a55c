"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips where ``torch.cuda.is_available()`` is
False. Run on the card with::

    python -m pytest -q -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance rtol=1e-5, atol=1e-6 for float32 and bf16 inputs alike (both are
upcast exactly and accumulated in float32; only the summation order of the
M-term dot products differs). A ``_q`` kernel on a compressed corpus also
equals its float32 twin on the dequantized corpus bit for bit (one body,
bit-equal rows), a tile-masked kernel equals ``where(tile, maxsim
kernel, 0)`` bit for bit (one body), and every reveal cell equals the dense
``maxsim`` kernel's cell bit for bit (the same sequential FMA chain over
M), whatever G and the order of the frontier rows. This file imports no
JAX.

The ``_q`` tests encode unit-norm doc token rows and score unit-norm query
rows, as the served corpus does: ColBERT and ``data/synthetic.py``
L2-normalize every token. Then sum_m |e_m q_m| is at most about 1 for
every cell (3 for the row coded Kc - 1), so a different summation order
moves a cell by about 1e-8, far inside atol, whatever the seed, while a
wrong term moves it by ~1/M.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import BanditConfig
from repro_torch.core.draws import TorchDraws
from repro_torch.data.synthetic import make_retrieval_dataset
from repro_torch.kernels import _build, ops
from repro_torch.kernels.gather_maxsim import gather_maxsim_cuda, \
    gather_maxsim_plain, gather_maxsim_q_cuda
from repro_torch.kernels.masked_maxsim import masked_maxsim_cuda, \
    masked_maxsim_plain, masked_maxsim_q_cuda
from repro_torch.kernels.maxsim import maxsim_batch_cuda, \
    maxsim_batch_plain, maxsim_batch_q_cuda
from repro_torch.kernels.quant import corpus_index, corpus_reshape, \
    dequantize, quantize
from repro_torch.kernels.reveal import fused_reveal_cuda, \
    fused_reveal_plain, fused_reveal_q_cuda, reveal_stats
from repro_torch.retrieval.corpus import build_corpus
from repro_torch.retrieval.index import from_numpy
from repro_torch.retrieval.pipeline import candidates_for, \
    rerank_query, serve_queries
from repro_torch.retrieval.service import init_stream_state, \
    make_serving_step, make_streaming_step, rerank_bandit_step
from repro_torch.serve import (AsyncRetrievalEngine, EngineConfig,
                               FaultPlan, InjectedFault, Request,
                               RetrievalEngine, pad_candidates,
                               support_bounds)
from test_torch_threads import cap_torch_threads

cap_torch_threads()

pytestmark = pytest.mark.cuda
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 through the chip "
                    "tool)")
    return torch.device("cuda")


def _docs(gen, D, L, M, dtype, dead=(0,)):
    e = torch.randn((D, L, M), generator=gen, device="cuda")
    lens = torch.randint(1, L + 1, (D,), generator=gen, device="cuda")
    mask = torch.arange(L, device="cuda")[None, :] < lens[:, None]
    mask[list(dead)] = False
    return e.to(dtype).contiguous(), mask.contiguous()


@pytest.mark.parametrize("B,N,L,T,M,dtype", [
    (4, 32, 128, 32, 128, torch.float32),
    (4, 32, 128, 32, 128, torch.bfloat16),
    (3, 5, 77, 45, 100, torch.float32),
    (2, 7, 200, 40, 64, torch.float32),
    (1, 9, 130, 64, 128, torch.float32),
    (2, 5, 128, 64, 128, torch.bfloat16)])
def test_maxsim_kernel_matches_plain(card, B, N, L, T, M, dtype):
    gen = torch.Generator(device=card).manual_seed(0)
    e, m = _docs(gen, B * N, L, M, dtype)
    e, m = e.reshape(B, N, L, M), m.reshape(B, N, L)
    q = torch.randn((B, T, M), generator=gen, device=card).to(dtype)
    got = maxsim_batch_cuda(e, m, q)
    torch.testing.assert_close(got, maxsim_batch_plain(e, m, q), rtol=RTOL,
                               atol=ATOL)
    assert float(got[0, 0].max()) == float(np.float32(-3e38))


@pytest.mark.parametrize("F,G,L,M,dtype", [
    (128, 8, 128, 128, torch.float32), (512, 1, 128, 128, torch.float32),
    (64, 8, 128, 128, torch.bfloat16), (1, 64, 77, 100, torch.float32)])
def test_reveal_kernels_match_plain(card, F, G, L, M, dtype):
    gen = torch.Generator(device=card).manual_seed(1)
    D, TQ = 256, 64
    e, m = _docs(gen, D, L, M, dtype)
    q = torch.randn((TQ, M), generator=gen, device=card).to(dtype)
    di = torch.randint(0, D, (F,), generator=gen, device=card)
    ti = torch.randint(0, TQ, (F, G), generator=gen, device=card)
    nm = torch.rand((F, G), generator=gen, device=card) < 0.5
    vals = gather_maxsim_cuda(e, m, q, di, ti)
    torch.testing.assert_close(vals, gather_maxsim_plain(e, m, q, di, ti),
                               rtol=RTOL, atol=ATOL)
    fv, fs = fused_reveal_cuda(e, m, q, di, ti, nm)
    pv, ps = fused_reveal_plain(e, m, q, di, ti, nm)
    assert torch.equal(fv, vals)
    torch.testing.assert_close(fv, pv, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(fs, ps, rtol=RTOL, atol=ATOL)


def test_serving_counts_launches_and_bodies_agree(card):
    ds = make_retrieval_dataset(n_docs=256, n_queries=4, doc_len=32,
                                min_doc_len=8, query_len=16, dim=64, seed=2)
    idx = from_numpy(ds.doc_embs, ds.doc_mask, ds.doc_lens, device=card)
    out = {}
    for engine, kernel in (("pooled", "fused_reveal"),
                           ("pooled_chain", "gather_maxsim")):
        _build.reset_launches()
        out[engine] = serve_queries(idx, ds.queries, k=5, max_candidates=64,
                                    bandit=BanditConfig(k=5), engine=engine,
                                    device=card)
        assert _build.LAUNCHES[kernel] > 0
    np.testing.assert_array_equal(out["pooled"].topk_ids,
                                  out["pooled_chain"].topk_ids)
    np.testing.assert_array_equal(out["pooled"].topk_scores,
                                  out["pooled_chain"].topk_scores)
    _build.reset_launches()
    serve_queries(idx, ds.queries, k=5, flavor="dense", max_candidates=64,
                  device=card)
    assert _build.LAUNCHES["maxsim"] == 1


# ---------------------------------------------------------------------------
# compressed corpora: the _q kernels
# ---------------------------------------------------------------------------

def _unit(x):
    return x / x.norm(dim=-1, keepdim=True)


def _quant_docs(gen, D, L, M, fmt, Kc=8, scale_dtype=torch.bfloat16):
    """A quantized corpus with an all-masked doc 0, a token row whose
    encoded row is all zero (scale 0: a zero row, or for the residual
    format a row on a centroid) and, for the residual format, a row coded
    Kc - 1."""
    e, m = _docs(gen, D, L, M, torch.float32)
    e = _unit(e)                             # unit rows, as a served corpus
    e[1, 0] = 0.0
    cb = None
    if fmt == "residual":
        cb = _unit(torch.randn((Kc, M), generator=gen, device="cuda"))
        e[1, 0] = cb[0]
        e[2, 0] = cb[Kc - 1] * 3.0
    qt = quantize(e, fmt, codebook=cb, scale_dtype=scale_dtype)
    assert float(qt.scales[1, 0]) == 0.0
    return qt, m


# Kc = 1,024 is beyond the codebook both layouts stage: read from global
# memory.
QFMTS = [("int8", 8, torch.bfloat16), ("residual", 8, torch.bfloat16),
         ("residual", 1, torch.bfloat16), ("residual", 8, torch.float32),
         ("residual", 1024, torch.bfloat16)]


@pytest.mark.parametrize("fmt,Kc,sdt", QFMTS)
@pytest.mark.parametrize("B,N,L,T,M", [(4, 32, 128, 32, 128),
                                       (3, 5, 77, 45, 100),
                                       (2, 7, 200, 40, 128),
                                       (1, 9, 130, 64, 100)])
def test_maxsim_q_matches_plain_and_its_f32_twin(card, fmt, Kc, sdt, B, N,
                                                 L, T, M):
    gen = torch.Generator(device=card).manual_seed(3)
    qt, m = _quant_docs(gen, B * N, L, M, fmt, Kc, sdt)
    qt, m = corpus_reshape(qt, B, N), m.reshape(B, N, L)
    q = _unit(torch.randn((B, T, M), generator=gen, device=card))
    got = maxsim_batch_q_cuda(qt, m, q)
    torch.testing.assert_close(got, maxsim_batch_plain(qt, m, q), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(got, maxsim_batch_cuda(dequantize(qt), m, q))
    assert float(got[0, 0].max()) == float(np.float32(-3e38))
    if fmt == "residual":
        assert int(qt.codes[0, 2, 0]) == Kc - 1


@pytest.mark.parametrize("fmt,Kc,sdt", QFMTS)
@pytest.mark.parametrize("F,G,L,M", [(128, 8, 128, 128), (512, 1, 128, 128),
                                     (1, 64, 77, 100)])
def test_reveal_q_kernels_match_plain_and_their_f32_twins(card, fmt, Kc,
                                                          sdt, F, G, L, M):
    gen = torch.Generator(device=card).manual_seed(4)
    D, TQ = 256, 64
    qt, m = _quant_docs(gen, D, L, M, fmt, Kc, sdt)
    q = _unit(torch.randn((TQ, M), generator=gen, device=card))
    di = torch.randint(0, D, (F,), generator=gen, device=card)
    di[0] = 0
    ti = torch.randint(0, TQ, (F, G), generator=gen, device=card)
    nm = torch.rand((F, G), generator=gen, device=card) < 0.5
    vals = gather_maxsim_q_cuda(qt, m, q, di, ti)
    torch.testing.assert_close(vals, gather_maxsim_plain(qt, m, q, di, ti),
                               rtol=RTOL, atol=ATOL)
    fv, fs = fused_reveal_q_cuda(qt, m, q, di, ti, nm)
    pv, ps = fused_reveal_plain(qt, m, q, di, ti, nm)
    assert torch.equal(fv, vals)
    torch.testing.assert_close(fs, ps, rtol=RTOL, atol=ATOL)
    dense = dequantize(qt)
    assert torch.equal(vals, gather_maxsim_cuda(dense, m, q, di, ti))
    tv, ts = fused_reveal_cuda(dense, m, q, di, ti, nm)
    assert torch.equal(fv, tv) and torch.equal(fs, ts)


def test_q_wrappers_raise_on_malformed_operands(card):
    gen = torch.Generator(device=card).manual_seed(5)
    qt, m = _quant_docs(gen, 8, 16, 32, "residual")
    q = torch.randn((4, 32), generator=gen, device=card)
    di = torch.zeros((2,), dtype=torch.int64, device=card)
    ti = torch.zeros((2, 2), dtype=torch.int64, device=card)
    for bad, match in (
            (qt._replace(data=qt.data.float()), "int8"),
            (qt._replace(scales=qt.scales.half()), "scales"),
            (qt._replace(codes=qt.codes.long()), "int32"),
            (qt._replace(codebook=None), "come together"),
            (qt._replace(codebook=qt.codebook.cpu()), "CUDA")):
        with pytest.raises(ValueError, match=match):
            gather_maxsim_q_cuda(bad, m, q, di, ti)
    # A codebook too large to stage launches (read from global memory);
    # token lists beyond a block's shared memory still raise.
    big = qt._replace(codebook=torch.zeros((2048, 32), device=card))
    torch.testing.assert_close(gather_maxsim_q_cuda(big, m, q, di, ti),
                               gather_maxsim_plain(big, m, q, di, ti),
                               rtol=RTOL, atol=ATOL)
    long_qt, long_m = _quant_docs(gen, 4, 30000, 32, "residual")
    with pytest.raises(ValueError, match="shared memory"):
        gather_maxsim_q_cuda(long_qt, long_m, q, di, ti)
    with pytest.raises(ValueError, match="QuantTokens"):
        maxsim_batch_cuda(corpus_reshape(qt, 1, 8), m[None], q[None])


@pytest.mark.parametrize("fmt", ["int8", "residual"])
def test_compressed_serving_launches_the_q_kernels(card, fmt):
    ds = make_retrieval_dataset(n_docs=256, n_queries=4, doc_len=32,
                                min_doc_len=8, query_len=16, dim=64, seed=6)
    idx = from_numpy(ds.doc_embs, ds.doc_mask, ds.doc_lens, device=card)
    q = torch.as_tensor(ds.queries, device=card)
    cand = candidates_for(idx.doc_embs, idx.doc_mask, q, kprime=10,
                          max_candidates=64, support=(0.0, 1.0))
    corpus = build_corpus(ds.doc_embs, ds.doc_mask, corpus_format=fmt,
                          device=card)
    args = (corpus.embs, corpus.mask, q, cand.doc_ids, cand.a, cand.b)
    out = {}
    for engine, kernel in (("pooled", "fused_reveal_q"),
                           ("pooled_chain", "gather_maxsim_q")):
        _build.reset_launches()
        out[engine] = make_serving_step("bandit", topk=5, engine=engine)(
            *args, TorchDraws().keys(0, q.shape[0], card))
        assert _build.LAUNCHES[kernel] > 0
        assert _build.LAUNCHES["fused_reveal"] == 0
        assert _build.LAUNCHES["gather_maxsim"] == 0
    for g, w in zip(out["pooled"], out["pooled_chain"]):
        assert torch.equal(g, w)
    _build.reset_launches()
    make_serving_step("dense", topk=5)(*args)
    assert _build.LAUNCHES["maxsim_q"] == 1 and _build.LAUNCHES["maxsim"] == 0


# ---------------------------------------------------------------------------
# tile-masked MaxSim
# ---------------------------------------------------------------------------

MASKED_FMTS = [("f32", 0), ("bf16", 0), ("int8", 0), ("residual", 8),
               ("residual", 1), ("residual", 1024)]


def _half_tiles(grid, bt, device):
    """Even tile rows active only over the tiles that start in query rows
    16..31 (one 16-row query half of the first pass), odd rows inactive."""
    j = torch.arange(grid[1], device=device) * bt
    cols = (j >= 16) & (j < 32)
    rows = torch.arange(grid[0], device=device) % 2 == 0
    return (rows[:, None] & cols[None, :]).contiguous()


@pytest.mark.parametrize("tiles", ["random", "none", "all", "half"])
@pytest.mark.parametrize("fmt,Kc", MASKED_FMTS)
@pytest.mark.parametrize("N,L,T,M,bn,bt", [
    (256, 128, 32, 128, 8, 8), (5, 77, 19, 100, 4, 4),
    (7, 77, 32, 100, 3, 8), (6, 128, 32, 128, 1, 8),
    (9, 130, 45, 64, 3, 5), (8, 100, 64, 128, 2, 40),
    (7, 77, 45, 100, 3, 40)])
def test_masked_maxsim_matches_plain_and_the_maxsim_twin(card, fmt, Kc, N,
                                                         L, T, M, bn, bt,
                                                         tiles):
    """Docs 0 and N - 1 are all-masked; under the random mask (density
    0.4) doc 0's tiles are all active and doc N - 1's all inactive. bn = 3
    and 1 put the two docs of a block in different tile rows, bt = 5 does
    not divide the 32-row pass, and bt = 40 spans both passes of T = 45 and
    64, so a pass of a doc can have no active tile; the half mask leaves
    one 16-row query half of a doc active."""
    gen = torch.Generator(device=card).manual_seed(7)
    dt = torch.bfloat16 if fmt == "bf16" else torch.float32
    if fmt in ("f32", "bf16"):
        e, m = _docs(gen, N, L, M, torch.float32)
        e = _unit(e).to(dt).contiguous()
    else:
        e, m = _quant_docs(gen, N, L, M, fmt, Kc)
    m[N - 1] = False
    q = _unit(torch.randn((T, M), generator=gen, device=card)).to(dt)
    grid = (-(-N // bn), -(-T // bt))
    if tiles == "random":
        tm = torch.rand(grid, generator=gen, device=card) < 0.4
        tm[0], tm[(N - 1) // bn] = True, False
    elif tiles == "half":
        tm = _half_tiles(grid, bt, card)
    else:
        tm = torch.full(grid, tiles == "all", dtype=torch.bool, device=card)
    _build.reset_launches()
    got = ops.masked_maxsim_op(e, m, q, tm, block_n=bn, block_t=bt)
    kernel = "masked_maxsim" if fmt in ("f32", "bf16") else "masked_maxsim_q"
    assert _build.LAUNCHES[kernel] == 1 and sum(_build.LAUNCHES.values()) == 1
    torch.testing.assert_close(got, masked_maxsim_plain(e, m, q, tm, bn, bt),
                               rtol=RTOL, atol=ATOL)
    full = tm.repeat_interleave(bn, 0).repeat_interleave(bt, 1)[:N, :T]
    assert torch.equal(got, torch.where(full, ops.maxsim_op(e, m, q), 0.0))
    neg = float(np.float32(-3e38))
    if tiles in ("random", "all"):
        assert (got[0] == neg).all()
    if tiles in ("random", "none"):
        assert (got[N - 1] == 0.0).all()
    if tiles == "none":
        assert not got.any()


def test_masked_wrappers_raise_on_malformed_operands(card):
    """Every malformed operand raises before a launch; nothing falls back
    and no refused call is counted."""
    gen = torch.Generator(device=card).manual_seed(8)
    e, m = _docs(gen, 16, 8, 32, torch.float32)
    qt, _ = _quant_docs(gen, 16, 8, 32, "int8")
    q = torch.randn((8, 32), generator=gen, device=card)
    tm = torch.ones((2, 2), dtype=torch.bool, device=card)   # bn=8, bt=4
    _build.reset_launches()
    for bad, match in ((tm.float(), "bool"), (tm[:1], "tile_mask must be"),
                       (tm.t(), "contiguous"), (tm.cpu(), "CUDA")):
        with pytest.raises(ValueError, match=match):
            masked_maxsim_cuda(e, m, q, bad, 8, 4)
        with pytest.raises(ValueError, match=match):
            masked_maxsim_q_cuda(qt, m, q, bad, 8, 4)
    with pytest.raises(ValueError, match=">= 1"):
        masked_maxsim_cuda(e, m, q, tm, 0, 4)
    with pytest.raises(ValueError, match="QuantTokens"):
        masked_maxsim_q_cuda(e, m, q, tm, 8, 4)
    with pytest.raises(ValueError, match="QuantTokens"):
        masked_maxsim_cuda(qt, m, q, tm, 8, 4)
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        ops.masked_maxsim_op(e, m, q, tm.cpu(), block_n=8, block_t=4)
    with pytest.raises(ValueError, match="tile_mask must be"):
        ops.masked_maxsim_op(e, m, q, tm[:, :1], block_n=8, block_t=4)
    assert not any(_build.LAUNCHES.values())
    masked_maxsim_cuda(e, m, q, tm, 8, 4)
    assert _build.LAUNCHES["masked_maxsim"] == 1


# ---------------------------------------------------------------------------
# the reveal body's cell arithmetic: one sequential FMA chain, as maxsim's
# ---------------------------------------------------------------------------

REVEAL_FMTS = [("f32", 0), ("bf16", 0), ("int8", 0), ("residual", 8),
               ("residual", 1), ("residual", 1024)]


def _reveal_corpus(gen, D, L, M, fmt, Kc, holes):
    """Unit-norm rows in ``fmt``, doc 0 all-masked; with ``holes`` every
    doc's valid tokens are a random third-free subset, not a prefix."""
    if fmt in ("f32", "bf16"):
        e, m = _docs(gen, D, L, M, torch.float32)
        e = _unit(e).to(torch.bfloat16 if fmt == "bf16" else torch.float32)
        e = e.contiguous()
    else:
        e, m = _quant_docs(gen, D, L, M, fmt, Kc or 8)
    if holes:
        m = torch.rand((D, L), generator=gen, device="cuda") < 0.6
        m[0] = False
    return e, m.contiguous()


def _reveal_all(e, m, q, di, ti, nm):
    """gather and fused values of the float or _q entry points, checked
    equal, and the fused stats."""
    quant = not isinstance(e, torch.Tensor)
    gather = gather_maxsim_q_cuda if quant else gather_maxsim_cuda
    fused = fused_reveal_q_cuda if quant else fused_reveal_cuda
    vals = gather(e, m, q, di, ti)
    fv, fs = fused(e, m, q, di, ti, nm)
    assert torch.equal(fv, vals)
    return vals, fs


def _maxsim_cells(e, m, q, di, ti):
    """The dense maxsim kernel's cells (doc di[f], query row ti[f, g])."""
    F = di.shape[0]
    md = m[di][None].contiguous()
    if isinstance(e, torch.Tensor):
        h = maxsim_batch_cuda(e[di][None].contiguous(), md, q[None])
    else:
        h = maxsim_batch_q_cuda(corpus_reshape(corpus_index(e, di), 1, F), md,
                                q[None])
    return torch.gather(h[0], 1, ti)


@pytest.mark.parametrize("fmt,Kc", REVEAL_FMTS)
@pytest.mark.parametrize("F,G,L,M,holes", [
    (128, 8, 128, 128, False), (64, 8, 200, 128, True),
    (37, 3, 77, 100, True), (16, 64, 128, 128, False),
    (24, 96, 128, 128, True), (9, 128, 77, 100, False)])
def test_reveal_cells_equal_the_dense_maxsim_cells(card, fmt, Kc, F, G, L,
                                                   M, holes):
    """All four reveal entry points give the dense maxsim kernel's cells bit
    for bit: L=200 spans several staging chunks, holes make the valid
    tokens no prefix, M=100 int8 rows are not 16-byte aligned, G = 96 and
    128 run in chunks of 64 query rows, and Kc = 1,024 reads the codebook
    from global memory."""
    gen = torch.Generator(device=card).manual_seed(9)
    D, TQ = 256, 64
    e, m = _reveal_corpus(gen, D, L, M, fmt, Kc, holes)
    q = _unit(torch.randn((TQ, M), generator=gen, device=card))
    if fmt == "bf16":
        q = q.to(torch.bfloat16)
    di = torch.randint(0, D, (F,), generator=gen, device=card)
    di[0] = 0
    ti = torch.randint(0, TQ, (F, G), generator=gen, device=card)
    nm = torch.rand((F, G), generator=gen, device=card) < 0.5
    vals, fs = _reveal_all(e, m, q, di, ti, nm)
    assert torch.equal(vals, _maxsim_cells(e, m, q, di, ti))
    assert float(vals[0].max()) == float(np.float32(-3e38))
    torch.testing.assert_close(vals, gather_maxsim_plain(e, m, q, di, ti),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(fs, fused_reveal_plain(e, m, q, di, ti, nm)[1],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fmt,Kc", REVEAL_FMTS)
def test_reveal_cell_is_independent_of_G_and_row_order(card, fmt, Kc):
    """A cell's value depends only on (doc row, query row): the same at
    G=8 and G=1, and under a permutation of the frontier rows."""
    gen = torch.Generator(device=card).manual_seed(10)
    D, TQ, F, G, L, M = 128, 32, 96, 8, 150, 128
    e, m = _reveal_corpus(gen, D, L, M, fmt, Kc, True)
    q = _unit(torch.randn((TQ, M), generator=gen, device=card))
    if fmt == "bf16":
        q = q.to(torch.bfloat16)
    di = torch.randint(0, D, (F,), generator=gen, device=card)
    ti = torch.randint(0, TQ, (F, G), generator=gen, device=card)
    nm = torch.rand((F, G), generator=gen, device=card) < 0.5
    vals, _ = _reveal_all(e, m, q, di, ti, nm)
    for g in range(G):
        one, _ = _reveal_all(e, m, q, di, ti[:, g:g + 1].contiguous(),
                             nm[:, g:g + 1].contiguous())
        assert torch.equal(one[:, 0], vals[:, g])
    perm = torch.randperm(F, generator=gen, device=card)
    pv, _ = _reveal_all(e, m, q, di[perm].contiguous(),
                        ti[perm].contiguous(), nm[perm].contiguous())
    assert torch.equal(pv, vals[perm])


def test_reveal_raises_beyond_64_query_rows(card):
    """Beyond 64 query rows a frontier row runs in chunks of 64: G = 65 and
    200 launch, each cell equals the same cell at G = 1, the stats equal
    reveal_stats' serial order; what still cannot fit (token lists beyond a
    block's shared memory) raises before any launch."""
    gen = torch.Generator(device=card).manual_seed(11)
    e, m = _docs(gen, 8, 16, 32, torch.float32)
    e = _unit(e)
    q = _unit(torch.randn((40, 32), generator=gen, device=card))
    di = torch.tensor([1, 5, 0], dtype=torch.int64, device=card)
    _build.reset_launches()
    for G in (64, 65, 200):
        ti = torch.randint(0, 40, (3, G), generator=gen, device=card)
        nm = torch.rand((3, G), generator=gen, device=card) < 0.5
        vals, fs = _reveal_all(e, m, q, di, ti, nm)
        for g in (0, 63, G - 1):
            one, _ = _reveal_all(e, m, q, di, ti[:, g:g + 1].contiguous(),
                                 nm[:, g:g + 1].contiguous())
            assert torch.equal(one[:, 0], vals[:, g])
        torch.testing.assert_close(
            vals, gather_maxsim_plain(e, m, q, di, ti), rtol=RTOL,
            atol=ATOL)
        assert torch.equal(fs, reveal_stats(vals, nm))
    launched = _build.LAUNCHES["gather_maxsim"]
    long_e, long_m = _docs(gen, 2, 60000, 32, torch.float32)
    ti = torch.zeros((2, 8), dtype=torch.int64, device=card)
    with pytest.raises(ValueError, match="shared memory"):
        gather_maxsim_cuda(long_e, long_m, q, di[:2], ti)
    assert _build.LAUNCHES["gather_maxsim"] == launched


# ---------------------------------------------------------------------------
# the dense body: compacted chunks, several docs a block, query passes
# ---------------------------------------------------------------------------

EDGE_LENS = (0, 1, 63, 64, 65, 127, 128, 129, 200)   # around 64-token chunks


@pytest.mark.parametrize("fmt,Kc", [("f32", 0), ("bf16", 0), ("int8", 0),
                                    ("residual", 8)])
@pytest.mark.parametrize("T,M", [(32, 128), (64, 100)])
@pytest.mark.parametrize("holes", [False, True])
def test_maxsim_cells_are_independent_of_the_launch(card, fmt, Kc, T, M,
                                                    holes):
    """The dense kernels on docs whose valid tokens end at the chunk edges
    (or are a random subset): each cell equals the same doc launched alone
    bit for bit, whatever its neighbours in a block, and the plain
    version within tolerance; a _q cell equals the f32 kernel's on the
    dequantized corpus."""
    gen = torch.Generator(device=card).manual_seed(12)
    N, L = len(EDGE_LENS), 200
    e, _ = _reveal_corpus(gen, N, L, M, fmt, Kc, False)
    lens = torch.tensor(EDGE_LENS, device=card)
    m = torch.arange(L, device=card)[None] < lens[:, None]
    if holes:
        m = m & (torch.rand((N, L), generator=gen, device=card) < 0.6)
    m = m.contiguous()
    q = _unit(torch.randn((T, M), generator=gen, device=card))
    if fmt == "bf16":
        q = q.to(torch.bfloat16)
    quant = not isinstance(e, torch.Tensor)
    kernel = maxsim_batch_q_cuda if quant else maxsim_batch_cuda
    got = kernel(corpus_reshape(e, 1, N), m[None], q[None])[0]
    alone = kernel(corpus_reshape(e, N, 1), m[:, None].contiguous(),
                   q[None].expand(N, T, M).contiguous())[:, 0]
    assert torch.equal(got, alone)
    torch.testing.assert_close(got, maxsim_batch_plain(
        corpus_reshape(e, 1, N), m[None], q[None])[0], rtol=RTOL, atol=ATOL)
    assert (got[0] == float(np.float32(-3e38))).all()
    if quant:
        assert torch.equal(got, maxsim_batch_cuda(
            dequantize(e)[None], m[None], q[None])[0])


def test_maxsim_raises_beyond_shared_memory(card):
    """A doc length too large for one block's shared memory raises before
    any launch, in the dense and the masked wrappers (one body, one
    layout); nothing falls back. A codebook too large to stage launches:
    it is read from global memory, equal to the plain version."""
    gen = torch.Generator(device=card).manual_seed(13)
    qt, m = _quant_docs(gen, 8, 16, 32, "residual")
    q = torch.randn((1, 4, 32), generator=gen, device=card)
    tm = torch.ones((1, 1), dtype=torch.bool, device=card)   # bn=8, bt=4
    big = qt._replace(codebook=torch.zeros((2048, 32), device=card))
    long_e, long_m = _docs(gen, 2, 30000, 32, torch.float32)
    _build.reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        maxsim_batch_cuda(long_e[None], long_m[None], q)
    with pytest.raises(ValueError, match="shared memory"):
        masked_maxsim_cuda(long_e, long_m, q[0], tm, 8, 4)
    assert not any(_build.LAUNCHES.values())
    maxsim_batch_q_cuda(corpus_reshape(qt, 1, 8), m[None], q)
    masked_maxsim_q_cuda(qt, m, q[0], tm, 8, 4)
    got = maxsim_batch_q_cuda(corpus_reshape(big, 1, 8), m[None], q)
    torch.testing.assert_close(got, maxsim_batch_plain(
        corpus_reshape(big, 1, 8), m[None], q), rtol=RTOL, atol=ATOL)
    assert torch.equal(masked_maxsim_q_cuda(big, m, q[0], tm, 8, 4), got[0])
    masked_maxsim_cuda(long_e[:, :16].contiguous(),
                       long_m[:, :16].contiguous(), q[0], tm, 8, 4)
    assert _build.LAUNCHES["maxsim_q"] == 2
    assert _build.LAUNCHES["masked_maxsim_q"] == 2
    assert _build.LAUNCHES["masked_maxsim"] == 1


# ---------------------------------------------------------------------------
# the streaming API, the fidelity knobs, the lockstep engine and the
# research harness on the card
# ---------------------------------------------------------------------------

def test_torch_draws_on_the_card_equal_the_cpu_bits(card):
    """Integer bits and uniforms are equal on both devices bit for bit; the
    Gumbel transform's log may round differently, so to 1e-6."""
    draws = TorchDraws()
    seeds = draws.keys(3, 6, card)
    assert torch.equal(seeds.cpu(), draws.keys(3, 6, "cpu"))
    s_dev, t_dev = draws.init(seeds, None, None, 40, 32)
    s_cpu, t_cpu = draws.init(seeds.cpu(), None, None, 40, 32)
    assert torch.equal(t_dev.cpu(), t_cpu) and torch.equal(s_dev.cpu(),
                                                           s_cpu)
    for _ in range(3):
        s_dev, u_dev, g_dev = draws.round(s_dev, 8, 32)
        s_cpu, u_cpu, g_cpu = draws.round(s_cpu, 8, 32)
        assert torch.equal(u_dev.cpu(), u_cpu)
        torch.testing.assert_close(g_dev.cpu(), g_cpu, rtol=1e-6, atol=1e-6)


def _stream_case(card, fmt):
    ds = make_retrieval_dataset(n_docs=256, n_queries=6, doc_len=32,
                                min_doc_len=8, query_len=16, dim=64, seed=8)
    idx = from_numpy(ds.doc_embs, ds.doc_mask, ds.doc_lens, device=card)
    q = torch.as_tensor(ds.queries, device=card)
    cand = candidates_for(idx.doc_embs, idx.doc_mask, q, kprime=10,
                          max_candidates=64, support=(0.0, 1.0))
    corpus = build_corpus(ds.doc_embs, ds.doc_mask, corpus_format=fmt,
                          device=card)
    return corpus, q, cand, TorchDraws().keys(8, q.shape[0], card)


@pytest.mark.parametrize("fmt,kernel", [("bf16", "fused_reveal"),
                                        ("int8", "fused_reveal_q")])
def test_streaming_step_on_the_card_equals_one_shot(card, fmt, kernel):
    corpus, q, cand, seeds = _stream_case(card, fmt)
    one = rerank_bandit_step(corpus.embs, corpus.mask, q, cand.doc_ids,
                             cand.a, cand.b, seeds, topk=5)
    S, (B, N), T = 2, cand.doc_ids.shape, q.shape[1]
    step = make_streaming_step(topk=5, trip_limit=3)
    state = init_stream_state(S, N, T, device=card)
    queue, slot_q, got = list(range(2, B)), [0, 1], {}
    fresh = torch.ones(S, dtype=torch.bool, device=card)
    _build.reset_launches()
    while len(got) < B:
        ix = torch.tensor(slot_q, device=card)
        _, ids, frac, _, harvest, state = step(
            corpus.embs, corpus.mask, q[ix], cand.doc_ids[ix], cand.a[ix],
            cand.b[ix], state, fresh, seeds[ix])
        fresh = torch.zeros(S, dtype=torch.bool, device=card)
        for s in range(S):
            if bool(harvest[s]) and slot_q[s] not in got:
                got[slot_q[s]] = (ids[s], frac[s])
                if queue:
                    slot_q[s] = queue.pop(0)
                    fresh[s] = True
    assert _build.LAUNCHES[kernel] > 0
    for b, (ids, frac) in got.items():
        assert torch.equal(ids, one[1][b]) and torch.equal(frac, one[2][b])


def test_knobs_on_the_card(card):
    corpus, q, cand, seeds = _stream_case(card, "bf16")
    args = (corpus.embs, corpus.mask, q, cand.doc_ids, cand.a, cand.b, seeds)
    base = rerank_bandit_step(*args, topk=5)
    one = rerank_bandit_step(*args, topk=5,
                             alpha_scale=torch.tensor(1.0, device=card),
                             round_cap=torch.tensor(0, device=card))
    for g, w in zip(one, base):
        assert torch.equal(g, w)
    # seeds made on the CPU (TorchDraws.keys' default) move to the card
    for g, w in zip(rerank_bandit_step(*args[:-1], seeds.cpu(), topk=5),
                    base):
        assert torch.equal(g, w)
    capped = rerank_bandit_step(*args, topk=5, alpha_scale=8.0,
                                round_cap=torch.tensor(4, device=card))
    assert float(capped[2].mean()) <= float(base[2].mean())
    lock = rerank_bandit_step(*args, topk=5, engine="vmapped")
    assert torch.isfinite(lock[0]).all() and lock[1].shape == (6, 5)


def test_rerank_query_on_the_card_runs_the_dense_kernel(card):
    ds = make_retrieval_dataset(n_docs=256, n_queries=2, doc_len=32,
                                min_doc_len=8, query_len=16, dim=64, seed=9)
    idx = from_numpy(ds.doc_embs, ds.doc_mask, ds.doc_lens, device=card)
    _build.reset_launches()
    res = rerank_query(idx, ds.queries[0], method="exact", use_kernel=True,
                       max_candidates=64)
    assert _build.LAUNCHES["maxsim"] == 1
    assert res.overlap == 1.0 and res.coverage == 1.0
    bandit = rerank_query(idx, ds.queries[0], method="bandit",
                          use_kernel=True, max_candidates=64)
    assert bandit.coverage < 1.0 and bandit.flops < bandit.flops_exact


# ---------------------------------------------------------------------------
# the serving engine on the card
# ---------------------------------------------------------------------------

def _engine_case(card, fmt):
    """A 256-doc corpus, 8 requests a batch of 4: 32 stage-1 candidates
    (bandit bucket) and their first 16 (dense bucket), plus stage-1
    requests on a float corpus."""
    corpus, q, cand, _ = _stream_case(card, fmt)
    ds = make_retrieval_dataset(n_docs=256, n_queries=6, doc_len=32,
                                min_doc_len=8, query_len=16, dim=64, seed=8)
    cfg = EngineConfig(batch_size=4, deadline_s=30.0, token_buckets=(16,),
                       cand_buckets=(16, 32), max_k=5, flavor="auto",
                       bandit_min_candidates=32, stage1_candidates=32,
                       stage1_kprime=10, corpus_format=fmt)
    ids = [r[r >= 0].cpu().numpy()[:32] for r in cand.doc_ids]
    reqs = [Request(query=ds.queries[i], k=5, cand_ids=ids[i])
            for i in range(4)]
    reqs += [Request(query=ds.queries[i], k=5, cand_ids=ids[i][:16])
             for i in range(4)]
    if fmt == "bf16":
        reqs += [Request(query=ds.queries[i], k=5) for i in range(4)]
    return ds, cfg, reqs, corpus, q


def _serve(eng, reqs, started=False):
    eng.warmup()
    if started:
        with eng:
            for r in reqs:
                eng.submit(r)
            return {c.rid: c for c in eng.drain()}
    for r in reqs:
        eng.submit(r)
    return {c.rid: c for c in eng.drain()}


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_engine_on_the_card_equals_the_steps(card, fmt):
    """The sync engine's completions equal the serving steps called on the
    same padded inputs with the engine's batch seeds, bit for bit; the
    engine builds nothing after warmup and launches as the steps do."""
    ds, cfg, reqs, corpus, q = _engine_case(card, fmt)
    eng = RetrievalEngine(ds.doc_embs, ds.doc_mask, cfg, device=card)
    eng.warmup()
    _build.reset_launches()
    for r in reqs:
        eng.submit(r)
    got = {c.rid: c for c in eng.drain()}
    served = dict(_build.LAUNCHES)
    assert eng.metrics.compiles_after_warmup == 0
    draws, base = TorchDraws(), TorchDraws().key(0, card)
    _build.reset_launches()
    for ordinal in range(len(reqs) // 4):
        batch = reqs[4 * ordinal:4 * ordinal + 4]
        if batch[0].cand_ids is None:
            c1 = candidates_for(eng.corpus_embs, eng.corpus_mask, q[:4],
                                kprime=10, max_candidates=32,
                                support=(0.0, 1.0))
            cand, a, b = c1.doc_ids, c1.a, c1.b
        else:
            nb = 32 if len(batch[0].cand_ids) > 16 else 16
            cand_np = pad_candidates([r.cand_ids for r in batch], nb)
            a, b = (torch.as_tensor(x, device=card) for x in support_bounds(
                cand_np, [16] * 4, 16, (0.0, 1.0)))
            cand = torch.as_tensor(cand_np, device=card)
        flavor = "bandit" if cand.shape[1] == 32 else "dense"
        seeds = draws.split(draws.fold_in(base, ordinal), 4)
        want = make_serving_step(flavor, topk=5)(
            eng.corpus_embs, eng.corpus_mask, q[:4], cand, a, b, seeds,
            alpha_scale=1.0, round_cap=0)
        scores, ids, frac, _ = (x.cpu().numpy() for x in want)
        for i in range(4):
            c = got[4 * ordinal + i]
            assert c.flavor == flavor
            assert np.array_equal(c.topk_ids, ids[i])
            assert np.array_equal(c.topk_scores, scores[i])
            assert c.reveal_fraction == float(frac[i])
    assert served == dict(_build.LAUNCHES)
    q_ = "_q" if fmt == "int8" else ""
    assert served["fused_reveal" + q_] > 0 and served["maxsim" + q_] > 0


def test_async_engine_on_the_card_equals_sync(card):
    ds, cfg, reqs, _, _ = _engine_case(card, "bf16")
    want = _serve(RetrievalEngine(ds.doc_embs, ds.doc_mask, cfg,
                                  device=card), reqs)
    for mode in ("batch", "supervised"):
        eng = AsyncRetrievalEngine(
            ds.doc_embs, ds.doc_mask,
            dataclasses.replace(cfg, supervise=mode == "supervised"),
            fault_plan=(FaultPlan([InjectedFault("dispatch", 2, "kill")])
                        if mode == "supervised" else None), device=card)
        got = _serve(eng, reqs, started=True)
        assert sorted(got) == sorted(want)
        for rid, c in want.items():
            assert np.array_equal(got[rid].topk_ids, c.topk_ids)
            assert np.array_equal(got[rid].topk_scores, c.topk_scores)
        assert eng.metrics.compiles_after_warmup == 0


# ---------------------------------------------------------------------------
# sharded serving: S = 4 shards on the one card
# ---------------------------------------------------------------------------

def _sharded_case(card, n_docs=203):
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.retrieval.sharded import route_batch, shard_corpus

    ds = make_retrieval_dataset(n_docs=n_docs, n_queries=4, doc_len=48,
                                min_doc_len=8, query_len=16, dim=64, seed=7)
    mesh = make_mesh((2, 2), ("data", "model"), device=card)
    embs = torch.as_tensor(ds.doc_embs, device=card)
    mask = torch.as_tensor(ds.doc_mask, device=card)
    q = torch.as_tensor(ds.queries, device=card)
    cand = candidates_for(embs, mask, q, kprime=10, max_candidates=48,
                          support=(0.0, 1.0))
    sc = shard_corpus(embs, mask, mesh, n_centroids=4)
    cl, (al, bl) = route_batch(cand.doc_ids.cpu().numpy(),
                               (cand.a.cpu().numpy(), cand.b.cpu().numpy()),
                               sc.docs_per_shard, 4)
    routed = tuple(torch.as_tensor(x, device=card) for x in (cl, al, bl))
    return ds, mesh, embs, mask, q, cand, sc, routed


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_sharded_steps_on_the_card_equal_single_device(card, fmt):
    """A ragged 203-doc corpus over 4 shards of one card: the sharded
    dense step returns the flat dense step's top-5 (ids exact, scores
    within rtol/atol) with one maxsim launch per shard; the hard-bound
    sharded bandit returns dense's id sets through the reveal kernel."""
    from repro_torch.retrieval.service import make_sharded_serving_step
    from repro_torch.retrieval.sharded import shard_corpus

    ds, mesh, embs, mask, q, cand, sc, routed = _sharded_case(card)
    if fmt == "int8":
        sc = shard_corpus(embs, mask, mesh, corpus_format="int8")
        flat = build_corpus(ds.doc_embs, ds.doc_mask, corpus_format="int8",
                            device=card)
        fe, fm = flat.embs, flat.mask
    else:
        fe, fm = embs, mask
    q_ = "_q" if fmt == "int8" else ""
    want = make_serving_step("dense", topk=5)(fe, fm, q, cand.doc_ids,
                                              cand.a, cand.b, None)
    _build.reset_launches()
    got = make_sharded_serving_step(mesh, "dense", topk=5,
                                    corpus_format=fmt)(
        sc.embs, sc.mask, q, *routed, sc.valid_docs, 0)
    assert _build.LAUNCHES["maxsim" + q_] == 4
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
    _build.reset_launches()
    hard = make_sharded_serving_step(mesh, "bandit", topk=5, alpha_ef=1e9,
                                     corpus_format=fmt)(
        sc.embs, sc.mask, q, *routed, sc.valid_docs, 0)
    assert _build.LAUNCHES["fused_reveal" + q_] > 0
    for r in range(4):
        assert set(hard[1][r].tolist()) == set(want[1][r].tolist())
    assert hard[3].shape == (4, 4) and (hard[2] <= 1).all()


def test_routed_on_the_card_equals_host_routed(card):
    """Full coverage (k' = C * L, n_local >= c_loc): the routed step equals
    the host-routed sharded step bit for bit on the card, dense and
    bandit; with a failed shard no id of that shard comes back."""
    from repro_torch.retrieval.service import (make_routed_serving_step,
                                               make_sharded_serving_step)
    from repro_torch.retrieval.sharded import route_batch

    ds, mesh, embs, mask, q, _, sc, _ = _sharded_case(card)
    kp = embs.shape[0] * embs.shape[1]
    hc = candidates_for(embs, mask, q, kprime=kp, max_candidates=208,
                        support=(0.0, 1.0))
    cl, (al, bl) = route_batch(hc.doc_ids.cpu().numpy(),
                               (hc.a.cpu().numpy(), hc.b.cpu().numpy()),
                               sc.docs_per_shard, 4,
                               n_local=sc.docs_per_shard)
    routed = tuple(torch.as_tensor(x, device=card) for x in (cl, al, bl))
    for flavor in ("dense", "bandit"):
        host = make_sharded_serving_step(mesh, flavor, topk=5)(
            sc.embs, sc.mask, q, *routed, sc.valid_docs, 0)
        got = make_routed_serving_step(
            mesh, flavor, topk=5, n_local=sc.docs_per_shard, n_total=0,
            kprime=kp)(sc.embs, sc.mask, sc.router.centroids,
                       sc.router.shard_mass, q, sc.valid_docs, 0)
        for x, y in zip(got[:3], host[:3]):
            assert torch.equal(x, y), flavor
    down = make_routed_serving_step(mesh, "bandit", topk=5, n_local=32,
                                    n_total=48, kprime=10)(
        sc.embs, sc.mask, sc.router.centroids, sc.router.shard_mass, q,
        sc.valid_docs, 0, np.array([True, True, False, True]))
    ids = down[1].cpu().numpy()
    d = sc.docs_per_shard
    assert not ((ids >= 2 * d) & (ids < 3 * d)).any()


def test_mesh_engine_on_the_card_fails_over(card):
    """The engine on a (2, 2) mesh of one card: zero rebuilds after warmup
    across a failover and a restore; no completion holds a doc of the
    failed shard; the restored results equal the first pass (dense)."""
    ds = make_retrieval_dataset(n_docs=203, n_queries=4, doc_len=48,
                                min_doc_len=8, query_len=16, dim=64, seed=7)
    cfg = EngineConfig(batch_size=4, deadline_s=30.0, token_buckets=(16,),
                       cand_buckets=(32,), max_k=5, flavor="dense",
                       stage1_candidates=32,
                       mesh_axes=(("data", 2), ("model", 2)))
    eng = RetrievalEngine(ds.doc_embs, ds.doc_mask, cfg, device=card)
    eng.warmup()
    reqs = [Request(query=ds.queries[i], k=5,
                    cand_ids=np.arange(32) * 6 % 203) for i in range(4)]
    first = _serve(eng, reqs)
    eng.fail_shard(2)
    down = _serve(eng, reqs)
    d = eng.corpus.docs_per_shard
    for c in down.values():
        assert not ((c.topk_ids >= 2 * d) & (c.topk_ids < 3 * d)).any()
        assert c.coverage < 1.0
    eng.restore_shard(2)
    back = _serve(eng, reqs)
    for (r0, c0), c1 in zip(sorted(first.items()),
                            [back[r] for r in sorted(back)]):
        assert np.array_equal(c0.topk_ids, c1.topk_ids)
        assert np.array_equal(c0.topk_scores, c1.topk_scores)
    assert eng.metrics.compiles_after_warmup == 0
    assert eng.metrics.summary()["failovers"] == 1


# ---------------------------------------------------------------------------
# launch shapes as arguments (kernels/tuning.py): every candidate gives the
# default's bits
# ---------------------------------------------------------------------------

TUNE_FMTS = [("f32", 0), ("bf16", 0), ("int8", 0), ("residual", 8)]


@pytest.mark.parametrize("fmt,Kc", TUNE_FMTS)
@pytest.mark.parametrize("B,N,L,T,M", [(4, 32, 128, 32, 128),
                                       (3, 5, 77, 45, 100),
                                       (2, 7, 200, 64, 128)])
def test_maxsim_every_block_n_equals_the_default(card, fmt, Kc, B, N, L, T,
                                                 M):
    """Each block_n the dense kernel is built for (1, 2, 4) gives the
    default launch's H bit for bit (N = 5, 7 leave a ragged last block)
    and the plain version's within tolerance; the op resolves the default
    (2) from an empty table."""
    from repro_torch.kernels import tuning
    gen = torch.Generator(device=card).manual_seed(21)
    e, m = _reveal_corpus(gen, B * N, L, M, fmt, Kc, True)
    e, m = corpus_reshape(e, B, N), m.reshape(B, N, L).contiguous()
    q = _unit(torch.randn((B, T, M), generator=gen, device=card))
    if fmt == "bf16":
        q = q.to(torch.bfloat16)
    tuning.clear()
    default = ops.maxsim_batch_op(e, m, q)
    torch.testing.assert_close(default, maxsim_batch_plain(e, m, q),
                               rtol=RTOL, atol=ATOL)
    for block_n in (1, 2, 4):
        assert torch.equal(ops.maxsim_batch_op(e, m, q, block_n=block_n),
                           default)


@pytest.mark.parametrize("fmt,Kc", TUNE_FMTS)
@pytest.mark.parametrize("F,G,L,M", [(128, 8, 128, 128), (600, 1, 128, 128),
                                     (37, 3, 200, 100)])
def test_reveal_every_block_l_equals_the_default(card, fmt, Kc, F, G, L, M):
    """block_l 64 and 32 give the default launch's (0: by F) vals and stats
    bit for bit on both reveal ops, for F on either side of 512."""
    from repro_torch.kernels import tuning
    gen = torch.Generator(device=card).manual_seed(22)
    D, TQ = 256, 64
    e, m = _reveal_corpus(gen, D, L, M, fmt, Kc, True)
    q = _unit(torch.randn((TQ, M), generator=gen, device=card))
    if fmt == "bf16":
        q = q.to(torch.bfloat16)
    di = torch.randint(0, D, (F,), generator=gen, device=card)
    ti = torch.randint(0, TQ, (F, G), generator=gen, device=card)
    nm = torch.rand((F, G), generator=gen, device=card) < 0.5
    tuning.clear()
    vals = ops.gather_maxsim_op(e, m, q, di, ti)
    fv, fs = ops.fused_reveal_op(e, m, q, di, ti, nm)
    assert torch.equal(fv, vals)
    torch.testing.assert_close(vals, gather_maxsim_plain(e, m, q, di, ti),
                               rtol=RTOL, atol=ATOL)
    for block_l in (64, 32, 0):
        assert torch.equal(ops.gather_maxsim_op(e, m, q, di, ti,
                                                block_l=block_l), vals)
        tv, ts = ops.fused_reveal_op(e, m, q, di, ti, nm, block_l=block_l)
        assert torch.equal(tv, fv) and torch.equal(ts, fs)


def test_tuned_table_entries_reach_the_launch(card):
    """A recorded entry is what the op launches (its bits equal the
    default's), and an empty table gives today's launches: the default
    block_n's shared memory is block_n 2's, block_l 0's is 64's up to 512
    frontier rows and 32's above."""
    from repro_torch.kernels import tuning
    from repro_torch.kernels.gather_maxsim import reveal_block_l
    lib_r = _build.library("reveal.cu")
    lib_m = _build.library("maxsim.cu")
    for F in (128, 512, 513, 4096):
        want = 64 if F <= 512 else 32
        assert reveal_block_l(F, 0) == want
        assert (lib_r.colbandit_reveal_smem_bytes(F, 8, 128, 128, 4, 0, 0, 0)
                == lib_r.colbandit_reveal_smem_bytes(F, 8, 128, 128, 4, 0, 0,
                                                     want))
    assert lib_r.colbandit_reveal_smem_bytes(8, 8, 128, 128, 4, 0, 0, 48) == -2
    sizes = [lib_m.colbandit_maxsim_smem_bytes(128, 128, 4, 0, 0, n)
             for n in (1, 2, 4)]
    assert sizes[0] < sizes[1] < sizes[2]
    assert lib_m.colbandit_maxsim_smem_bytes(128, 128, 4, 0, 0, 3) == -1
    tuning.clear()
    assert tuning.lookup("maxsim_batch", dict(B=2, N=8, T=32, L=64, M=64)) \
        == {"block_n": 2}
    gen = torch.Generator(device=card).manual_seed(23)
    e, m = _docs(gen, 16, 64, 64, torch.float32)
    q = torch.randn((2, 32, 64), generator=gen, device=card)
    e, m = e.reshape(2, 8, 64, 64), m.reshape(2, 8, 64).contiguous()
    base = ops.maxsim_batch_op(e, m, q)
    dims = ops.launch_dims("maxsim_batch", e.shape, q.shape)
    tuning.record("maxsim_batch", dims, {"block_n": 4})
    try:
        assert ops._resolve("maxsim_batch", dims) == {"block_n": 4}
        assert torch.equal(ops.maxsim_batch_op(e, m, q), base)
    finally:
        tuning.clear()


def test_launch_shapes_that_do_not_fit_raise_before_the_launch(card):
    """An unknown block_n / block_l, or a shape whose shared memory exceeds
    the card's at that shape, raises ValueError before any launch; it never
    becomes the default."""
    gen = torch.Generator(device=card).manual_seed(24)
    e, m = _docs(gen, 8, 16, 32, torch.float32)
    q = torch.randn((4, 32), generator=gen, device=card)
    di = torch.zeros((2,), dtype=torch.int64, device=card)
    ti = torch.zeros((2, 2), dtype=torch.int64, device=card)
    _build.reset_launches()
    for bad in (3, 8, 0):
        with pytest.raises(ValueError, match="block_n"):
            maxsim_batch_cuda(e[None], m[None], q[None], bad)
        with pytest.raises(ValueError, match="block_n"):
            ops.maxsim_batch_op(e[None], m[None], q[None], block_n=bad)
    for bad in (16, 48, 128):
        with pytest.raises(ValueError, match="block_l"):
            gather_maxsim_cuda(e, m, q, di, ti, bad)
        with pytest.raises(ValueError, match="block_l"):
            ops.gather_maxsim_op(e, m, q, di, ti, block_l=bad)
    # L = 20000 f32 rows: the token lists of 1 doc a block fit in shared
    # memory, those of 4 do not.
    long_e, long_m = _docs(gen, 4, 20000, 32, torch.float32)
    lib = _build.library("maxsim.cu")
    fits = [lib.colbandit_maxsim_smem_bytes(20000, 32, 4, 0, 0, n)
            <= _build.SHARED_MEM_BYTES for n in (1, 2, 4)]
    assert fits[0] and not fits[2]
    with pytest.raises(ValueError, match="shared memory"):
        maxsim_batch_cuda(long_e[None], long_m[None], q[None], 4)
    assert not any(_build.LAUNCHES.values())
    maxsim_batch_cuda(long_e[None], long_m[None], q[None], 1)
    assert _build.LAUNCHES["maxsim"] == 1


def test_autotune_op_times_every_candidate_on_the_card(card):
    """autotune_op times each candidate of a bucket on the card (CUDA
    events), records the fastest and returns its timings."""
    from repro_torch.kernels import tuning
    tuning.clear()
    try:
        for op, dims in (
                ("maxsim_batch", dict(B=2, N=8, T=32, L=64, M=64)),
                ("maxsim_batch", dict(B=2, N=8, T=32, L=64, M=64, FMT=2)),
                ("fused_reveal", dict(B=64, G=8, L=64, M=64, D=128, TQ=64)),
                ("gather_maxsim", dict(B=64, G=8, L=64, M=64, D=128, TQ=64,
                                       FMT=4))):
            best, times = ops.autotune_op(op, dims, repeats=2)
            assert len(times) == len(tuning.candidates(op, dims))
            assert all(t > 0 for t in times.values())
            assert tuning.lookup(op, dims) == best
    finally:
        tuning.clear()


def test_engine_audit_on_the_card_reads_the_host_only_at_the_loop(card):
    """A warmed f32 engine passes its audit on the card (the bandit step's
    reads at run_loop, none in a trip); a step that copies to the host
    (``.cpu()``, a dispatched ``_to_copy``) fails ``hlo-host-sync``."""
    from repro_torch.analysis.audit import AuditError
    ds = make_retrieval_dataset(n_docs=64, doc_len=16, min_doc_len=8,
                                dim=32, query_len=8, n_queries=4, seed=0)
    cfg = EngineConfig(batch_size=2, token_buckets=(8,), cand_buckets=(16,
                       32), max_k=4, bandit_min_candidates=32, audit=True)
    eng = RetrievalEngine(ds.doc_embs, ds.doc_mask, cfg, device=card)
    eng.warmup()
    reports = eng.audit()
    bandit = reports[("step", "bandit", 8, 32)]
    assert set(bandit.host_reads) == {"core/frontier.py::run_loop"}
    assert bandit.host_reads["core/frontier.py::run_loop"] == bandit.trips + 1
    key = ("step", "dense", 8, 16)
    real = eng._exec[key]

    def leaky(*args):
        out = real(*args)
        out[0].cpu()
        return out
    eng._exec[key] = leaky
    with pytest.raises(AuditError, match="hlo-host-sync") as err:
        eng.audit()
    assert repr(key) in str(err.value) and "copy to the host" in str(
        err.value)


# ---------------------------------------------------------------------------
# the MoE FFN and the recsys models: the card against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,k,cf,no_drop", [(8, 2, 1.0, False),
                                            (64, 6, 1.25, False),
                                            (64, 6, 1.25, True)])
def test_moe_ffn_on_the_card_equals_the_cpu(card, E, k, cf, no_drop):
    """Same weights and tokens on both devices: routing equal but for a
    near-tie (top-k gap < 1e-4 on either side, ``compare_routing``), and
    every row before such a flip within atol 1e-5 (float32, no TF32)."""
    from repro_torch.models.moe import (capacity_of, compare_routing,
                                        gate_logits, init_moe, moe_ffn,
                                        moe_routing, topk_gap)
    gen = torch.Generator().manual_seed(E + k)
    cpu = init_moe(gen, 256, 128, E, device="cpu")
    on_card = init_moe(gen, 256, 128, E, device="cpu").to(card)
    on_card.load_state_dict(cpu.state_dict())
    x = torch.randn((2, 64, 256), generator=gen)
    cap = capacity_of(64, k, E, cf, no_drop)
    routes = []
    for m, xx in ((cpu, x), (on_card, x.to(card))):
        r = moe_routing(m, xx, top_k=k, capacity=cap)
        routes.append([(r.top_idx.cpu(),
                        topk_gap(gate_logits(m, xx), k).cpu())])
    diff = compare_routing(*routes)
    assert diff.wide == 0, diff
    want = moe_ffn(cpu, x, top_k=k, capacity_factor=cf, no_drop=no_drop)
    got = moe_ffn(on_card, x.to(card), top_k=k, capacity_factor=cf,
                  no_drop=no_drop).cpu()
    for b in range(2):
        f = int(diff.first_tainted[b])
        torch.testing.assert_close(got[b, :f], want[b, :f], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ["fm", "autoint", "din", "sasrec"])
def test_recsys_on_the_card_equals_the_cpu(card, arch):
    """Each model at a cut vocabulary (widths as the config): the forward
    at batch 64 and ``*_score_candidates`` over 3,000 candidates (chunks of
    1,024, so the padded last chunk runs) within atol 1e-5."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import recsys as R
    cfg = get_config(arch)
    if cfg.vocab_sizes:
        cfg = dataclasses.replace(cfg, vocab_sizes=tuple(
            min(v, 5000) for v in cfg.vocab_sizes))
    else:
        cfg = dataclasses.replace(cfg, item_vocab=20_000)
    cpu = getattr(R, f"init_{arch}")(cfg, seed=1, device="cpu")
    on_card = copy.deepcopy(cpu).to(card)
    g = torch.Generator().manual_seed(2)
    n, chunk = 3000, 1024
    if cfg.vocab_sizes:
        ids = torch.stack([torch.randint(0, v, (64,), generator=g)
                           for v in cfg.vocab_sizes], dim=1)
        fwd_args = (ids,)
        ctx = ids[0, :-1]
        cand = torch.randint(0, cfg.vocab_sizes[-1], (n,), generator=g)
        score_args = (ctx, cand)
    else:
        hist = torch.randint(0, cfg.item_vocab, (64, cfg.seq_len),
                             generator=g)
        mask = torch.arange(cfg.seq_len)[None, :] < torch.randint(
            1, cfg.seq_len + 1, (64, 1), generator=g)
        target = torch.randint(0, cfg.item_vocab, (64,), generator=g)
        fwd_args = (hist, mask, target)
        cand = torch.randint(0, cfg.item_vocab, (n,), generator=g)
        score_args = (hist[0], mask[0], cand)
    kw = dict(chunk=chunk) if arch in ("autoint", "din") else {}
    fwd = getattr(R, f"{arch}_forward")
    score = getattr(R, f"{arch}_score_candidates")
    for fn, args, extra in ((fwd, fwd_args, {}), (score, score_args, kw)):
        want = fn(cpu, cfg, *args, **extra)
        got = fn(on_card, cfg, *(a.to(card) for a in args), **extra)
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# training (chip_smoke.py phase 14 (b)): plain PyTorch and autograd on the
# card against the same step on the CPU, float32 with TF32 off
# ---------------------------------------------------------------------------

TRAIN_LM = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                d_head=16, d_ff=96, vocab=512, qkv_bias=True)


@pytest.fixture
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _lm_twins(card, spec, seed=0):
    from repro_torch.configs.base import LMConfig
    from repro_torch.models.transformer import DecoderLM, init_lm
    cfg = LMConfig(**spec)
    model = init_lm(cfg, seed=seed, device="cpu")
    twin = DecoderLM(cfg, torch.float32, card)
    twin.load_state_dict(model.state_dict())
    return cfg, model, twin


@pytest.mark.parametrize("mb", [1, 2])
def test_lm_train_step_card_matches_cpu(card, no_tf32, mb):
    """One step of make_lm_train_step (remat, chunked CE, AdamW eps 1e-4)
    on the card and on the CPU: loss atol 1e-5, grad_norm rtol 1e-5,
    updated parameters atol 1e-6 (lr 1e-4)."""
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.train_step import init_train_state, \
        make_lm_train_step
    cfg, cpu, dev = _lm_twins(card, TRAIN_LM)
    g = torch.Generator().manual_seed(1)
    seq = torch.randint(0, cfg.vocab, (4, 33), generator=g)
    batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:].clone()}
    batch["targets"][1, :5] = -1
    opt = adamw(1e-4, eps=1e-4)
    step = make_lm_train_step(cfg, opt, chunk_tokens=32, num_microbatches=mb)
    s_c, m_c = step(init_train_state(cpu, opt), batch)
    s_d, m_d = step(init_train_state(dev, opt),
                    {k: v.to(card) for k, v in batch.items()})
    assert m_d["loss"].device.type == "cuda"
    torch.testing.assert_close(m_d["loss"].cpu(), m_c["loss"], rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(m_d["grad_norm"].cpu(), m_c["grad_norm"],
                               rtol=1e-5, atol=0)
    for (k, p), (_, q) in zip(dev.named_parameters(),
                              cpu.named_parameters()):
        torch.testing.assert_close(p.detach().cpu(), q.detach(), rtol=0,
                                   atol=1e-6, msg=k)
        assert not p.requires_grad


def test_microbatches_on_card_match_one_batch(card, no_tf32):
    """num_microbatches=2 against 1 on the card's gradients (rows with
    equal target counts: the mean of the two means is the batch mean;
    rtol 1e-4 / atol 1e-6: the embedding's backward adds a token's rows
    with atomics, in another order in each split)."""
    from repro_torch.train.train_step import lm_grads
    cfg, _, dev = _lm_twins(card, TRAIN_LM, seed=2)
    g = torch.Generator().manual_seed(3)
    seq = torch.randint(0, cfg.vocab, (4, 33), generator=g).to(card)
    l1, g1 = lm_grads(dev, cfg, seq[:, :-1], seq[:, 1:])
    l2, g2 = lm_grads(dev, cfg, seq[:, :-1], seq[:, 1:], num_microbatches=2)
    torch.testing.assert_close(l2, l1, rtol=0, atol=1e-6)
    for k in g1:
        assert g2[k].dtype == torch.float32
        torch.testing.assert_close(g2[k], g1[k], rtol=1e-4, atol=1e-6,
                                   msg=k)


def test_pna_train_step_card_matches_cpu(card, no_tf32):
    """One PNA step on the card against the CPU: the scatters add with
    atomics there, and std's cancellation amplifies the order (loss rtol
    1e-4, grad_norm rtol 1e-3)."""
    from repro_torch.configs.base import GNNConfig
    from repro_torch.models import gnn as G
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.train_step import init_train_state, \
        make_gnn_train_step
    cfg = GNNConfig(name="pna", n_layers=3, d_hidden=16, n_classes=5)
    cpu = G.init_pna(cfg, 8, seed=0, device="cpu")
    dev = G.PNA(cfg, 8, torch.float32, card)
    dev.load_state_dict(cpu.state_dict())
    graph = G.random_graph(64, 300, 8, 5, seed=1)
    opt = adamw(1e-3)
    step = make_gnn_train_step(cfg, opt)
    _, m_c = step(init_train_state(cpu, opt), graph)
    _, m_d = step(init_train_state(dev, opt), graph.to(card))
    torch.testing.assert_close(m_d["loss"].cpu(), m_c["loss"], rtol=1e-4,
                               atol=0)
    torch.testing.assert_close(m_d["grad_norm"].cpu(), m_c["grad_norm"],
                               rtol=1e-3, atol=0)


# ---------------------------------------------------------------------------
# split-K decode and the ring collectives on the card (phase 15(a'), (b),
# (d))
# ---------------------------------------------------------------------------

GEMMA_LIKE = dict(name="g", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                  d_head=16, d_ff=128, vocab=256, sliding_window=8,
                  local_global_alternating=True, attn_softcap=50.0,
                  logit_softcap=30.0, act="gelu")


def test_split_k_decode_on_card_matches_plain(card, no_tf32):
    """A gemma-style decoder (ring caches, softcaps), float32, B = 2 on a
    (2, 4) ("data", "model") mesh of the card: 4 split-K steps from a
    prefill against the plain steps on the card (atol 1e-5) and on the
    CPU (atol 1e-4, JAX's decode bound), the ring wrapping."""
    from repro_torch.dist import flash_decode as FD
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.models.transformer import forward_decode, \
        forward_prefill
    cfg, cpu, dev = _lm_twins(card, GEMMA_LIKE, seed=4)
    g = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, cfg.vocab, (2, 12), generator=g)

    def run(model, device, mesh, toks=None):
        """4 decode steps from the prefill, greedy or fed ``toks``."""
        out, fed = [], []
        with torch.no_grad():
            last, cache = forward_prefill(model, cfg, prompt.to(device), 16,
                                          cache_dtype=torch.float32)
            tok = torch.argmax(last, -1)
            if mesh is not None:
                FD.configure(mesh, "data", "model")
            try:
                for step in range(4):
                    if toks is not None:
                        tok = toks[step].to(device)
                    fed.append(tok.cpu())
                    logits, cache = forward_decode(model, cfg, tok,
                                                   12 + step, cache)
                    out.append(logits.cpu())
                    tok = torch.argmax(logits, -1)
            finally:
                FD.configure(None, None, None)
        return out, fed

    ref, toks = run(cpu, "cpu", None)
    plain, _ = run(dev, card, None, toks)
    split, _ = run(dev, card, make_mesh((2, 4), ("data", "model"),
                                       device=card), toks)
    for r, p, s in zip(ref, plain, split):
        assert torch.isfinite(s).all()
        torch.testing.assert_close(s, p, rtol=0, atol=1e-5)
        torch.testing.assert_close(s, r, rtol=0, atol=1e-4)


def test_split_k_attention_on_card_matches_cpu(card):
    """flash_decode_attention over 8 sequence shards of the card against
    the CPU's (float32, an all-masked shard; atol 1e-5)."""
    from repro_torch.dist import flash_decode as FD
    from repro_torch.dist.mesh import make_mesh
    g = torch.Generator().manual_seed(6)
    qg = torch.randn((2, 1, 2, 3, 8), generator=g)
    k = torch.randn((2, 64, 2, 8), generator=g)
    v = torch.randn((2, 64, 2, 8), generator=g)
    kv_pos = torch.arange(64, dtype=torch.int32).expand(2, 64).clone()
    kv_pos[:, 50:] = -1
    q_pos = torch.full((2, 1), 49, dtype=torch.int32)
    args = (qg, k, v, kv_pos, kv_pos >= 0, q_pos)
    out = {}
    for device in ("cpu", card):
        FD.configure(make_mesh((8,), ("model",), device=device), None,
                     "model")
        try:
            out[str(device)] = FD.flash_decode_attention(
                *[a.to(device) for a in args], 16, 8 ** -0.5, 50.0).cpu()
        finally:
            FD.configure(None, None, None)
    torch.testing.assert_close(out[str(card)], out["cpu"], rtol=0,
                               atol=1e-5)


def test_split_k_over_per_device_blocks_on_card(card, no_tf32):
    """Phase 15(d) at test size: a gemma-style decoder (8-slot ring caches
    in 4 blocks of 2, wrapping during the steps), float32, B = 1, its cache
    placed on a (1, 4) mesh of the card x 2 and a second card x 2 (or the
    CPU x 2): each device holds exactly its two sequence blocks of every
    stack, and 4 split-K steps from the placed prefill equal the same steps
    on a one-device (1, 4) mesh of the card within atol 1e-4 (a CPU
    shard's partials sum in the CPU's order; JAX's decode bound)."""
    from repro_torch.dist import flash_decode as FD
    from repro_torch.dist.mesh import make_mesh
    from repro_torch.dist.sharding import lm_cache_specs
    from repro_torch.models.transformer import forward_decode, \
        forward_prefill
    _, _, model = _lm_twins(card, GEMMA_LIKE, seed=8)
    cfg = model.cfg
    other = (torch.device("cuda", 1) if torch.cuda.device_count() >= 2
             else torch.device("cpu"))
    one = make_mesh((1, 4), ("data", "model"), device=card)
    spread = make_mesh((1, 4), ("data", "model"),
                       devices=[card, card, other, other])
    prompt = torch.randint(0, cfg.vocab, (1, 12),
                           generator=torch.Generator().manual_seed(9))

    def run(mesh, toks=None):
        out, fed = [], []
        with torch.no_grad():
            last, cache = forward_prefill(model, cfg, prompt.to(card), 16,
                                          cache_dtype=torch.float32,
                                          mesh=mesh)
            tok = torch.argmax(last, -1)
            FD.configure(mesh, *lm_cache_specs(mesh, 1)["pos"])
            try:
                for step in range(4):
                    if toks is not None:
                        tok = toks[step]
                    fed.append(tok)
                    logits, cache = forward_decode(model, cfg, tok,
                                                   12 + step, cache)
                    out.append(logits.cpu())
                    tok = torch.argmax(logits, -1)
            finally:
                FD.configure(None, None, None)
        return out, fed, cache

    ref, toks, _ = run(one)
    got, _, cache = run(spread, toks)
    for name, st in cache.items():
        n, s_cache = len(st.k.parts[0]), st.pos.shape[1]
        per = (2 * n * s_cache * cfg.n_kv_heads * cfg.d_head + s_cache) * 4
        held = {}
        for blocks in st:
            for d, nb in blocks.bytes_by_device().items():
                held[d] = held.get(d, 0) + nb
        assert held == {spread.devices[0]: per // 2, other: per // 2}, name
    for r, g in zip(ref, got):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, r, rtol=0, atol=1e-4)


def test_ring_collectives_on_card(card, no_tf32):
    """4 shards of the card: ring_all_gather == torch.cat bit for bit on
    every shard, each result a fresh copy; ring_matmul in float32 ==
    x @ w within rtol 1e-5 (another row blocking may sum in another
    order); 3 hops noted, each carrying every shard's chunk."""
    from repro_torch.analysis.audit import Recorder
    from repro_torch.dist import collectives as C
    from repro_torch.dist.mesh import make_mesh
    mesh = make_mesh((4,), ("model",), device=card)
    g = torch.Generator(device=card).manual_seed(7)
    x = torch.randn((4 * 256, 128), generator=g, device=card)
    w = torch.randn((128, 384), generator=g, device=card)
    with Recorder() as rec:
        got = C.ring_all_gather(list(x.chunk(4)), mesh)
    assert rec.collective == {"collective-permute": 3 * x.numel() * 4}
    for s in got:
        assert torch.equal(s, x) and s.data_ptr() != x.data_ptr()
    for s in C.ring_matmul(list(x.chunk(4)), w, mesh):
        torch.testing.assert_close(s, x @ w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_launcher_count_on_meta_equals_the_card(card, no_tf32, kind):
    """The launcher's account counts FLOPs over the step on ``meta``; the
    same step on the card, on drawn arguments of the cell's shapes, counts
    the same under ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis.accounting import count_step
    from repro_torch.configs.base import LMConfig, ShapeSpec
    from repro_torch.launch import steps as launch_steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import init_cache, init_lm
    from repro_torch.train.optimizer import adamw, cosine_schedule
    from repro_torch.train.train_step import init_train_state

    cfg = LMConfig(name="tiny", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, d_head=16, d_ff=96, vocab=512,
                   qkv_bias=True)
    B, S = 4, 64
    mesh = make_host_mesh(1, device=card)
    cell = launch_steps._lm_cell(
        cfg, ShapeSpec(name=kind, kind=kind, seq_len=S, global_batch=B), mesh)
    _, count = count_step(cell.count)
    gen = torch.Generator(device=card).manual_seed(3)
    model = init_lm(cfg, seed=0, dtype=torch.bfloat16, device=card)

    def ids(*shape):
        return torch.randint(0, cfg.vocab, shape, generator=gen,
                             device=card, dtype=torch.int32)

    if kind == "prefill":
        args = (model, ids(B, S))
    elif kind == "decode":
        args = (model, ids(B), torch.tensor(S - 1, dtype=torch.int32,
                                            device=card),
                init_cache(cfg, B, S, torch.bfloat16, card))
    else:
        state = init_train_state(model, adamw(cosine_schedule(3e-4, 100,
                                                              10_000)))
        args = (state, {"tokens": ids(B, S), "targets": ids(B, S)})
    with FlopCounterMode(display=False) as fc:
        cell.fn(*args)
    torch.cuda.synchronize()
    assert count.flops > 0
    assert int(fc.get_total_flops()) == count.flops
