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
    fused_reveal_plain, fused_reveal_q_cuda
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


QFMTS = [("int8", 8, torch.bfloat16), ("residual", 8, torch.bfloat16),
         ("residual", 1, torch.bfloat16), ("residual", 8, torch.float32)]


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
    with pytest.raises(ValueError, match="shared memory"):
        big = qt._replace(codebook=torch.zeros((2048, 32), device=card))
        gather_maxsim_q_cuda(big, m, q, di, ti)
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
               ("residual", 1)]


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
               ("residual", 1)]


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
    (37, 3, 77, 100, True), (16, 64, 128, 128, False)])
def test_reveal_cells_equal_the_dense_maxsim_cells(card, fmt, Kc, F, G, L,
                                                   M, holes):
    """All four reveal entry points give the dense maxsim kernel's cells bit
    for bit: L=200 spans several staging chunks, holes make the valid
    tokens no prefix, M=100 int8 rows are not 16-byte aligned."""
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
    """G is at most 64; a larger G raises before any launch."""
    gen = torch.Generator(device=card).manual_seed(11)
    e, m = _docs(gen, 8, 16, 32, torch.float32)
    q = torch.randn((4, 32), generator=gen, device=card)
    di = torch.zeros((2,), dtype=torch.int64, device=card)
    _build.reset_launches()
    for G, ok in ((64, True), (65, False)):
        ti = torch.zeros((2, G), dtype=torch.int64, device=card)
        if ok:
            gather_maxsim_cuda(e, m, q, di, ti)
        else:
            with pytest.raises(ValueError, match="exceed"):
                gather_maxsim_cuda(e, m, q, di, ti)
    assert _build.LAUNCHES["gather_maxsim"] == 1


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
    """A residual codebook or a doc length too large for one block's shared
    memory raises before any launch, in the dense and the masked wrappers
    (one body, one layout); nothing falls back."""
    gen = torch.Generator(device=card).manual_seed(13)
    qt, m = _quant_docs(gen, 8, 16, 32, "residual")
    q = torch.randn((1, 4, 32), generator=gen, device=card)
    tm = torch.ones((1, 1), dtype=torch.bool, device=card)   # bn=8, bt=4
    big = qt._replace(codebook=torch.zeros((2048, 32), device=card))
    long_e, long_m = _docs(gen, 2, 30000, 32, torch.float32)
    _build.reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        maxsim_batch_q_cuda(corpus_reshape(big, 1, 8), m[None], q)
    with pytest.raises(ValueError, match="shared memory"):
        masked_maxsim_q_cuda(big, m, q[0], tm, 8, 4)
    with pytest.raises(ValueError, match="shared memory"):
        maxsim_batch_cuda(long_e[None], long_m[None], q)
    with pytest.raises(ValueError, match="shared memory"):
        masked_maxsim_cuda(long_e, long_m, q[0], tm, 8, 4)
    assert not any(_build.LAUNCHES.values())
    maxsim_batch_q_cuda(corpus_reshape(qt, 1, 8), m[None], q)
    masked_maxsim_q_cuda(qt, m, q[0], tm, 8, 4)
    masked_maxsim_cuda(long_e[:, :16].contiguous(),
                       long_m[:, :16].contiguous(), q[0], tm, 8, 4)
    assert _build.LAUNCHES["maxsim_q"] == 1
    assert _build.LAUNCHES["masked_maxsim_q"] == 1
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
