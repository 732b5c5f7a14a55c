"""Granite Vision Embedding page widths on the CPU, and the pooled steps
reading revealed docs in place in the resident corpus.

  * Page-shaped inputs through ``AsyncRetrievalEngine``: 64-token queries,
    512 pages of a fixed 45 patch tokens (not a multiple of 32), M = 16,
    64- and 256-wide candidate lists with padded slots, on a float32 and an
    int8 corpus, held to the benchmark's plain reference
    (``perfbench/reference/maxsim.py``; for the int8 corpus, over the
    embeddings it holds, dequantized). The dense flavor returns the
    reference's top-5 ids and scores within 1e-5; the pooled bandit at
    alpha_ef 1e9 reveals every cell and does the same, under the fused and
    the chain body; at alpha_ef 0.2 every cell a reveal launch returns is
    the reference's cell and the answers are distinct candidates.
  * The pooled batch and streaming steps over the resident corpus equal,
    bit for bit, the same steps over a corpus made of the gathered
    candidate block (ids ``arange(B*N)``, padded slots kept), at text and
    page shapes; and the batch's ``reveal_rows`` counter equals the rows
    its reveal launches staged, the init launch's Q*N and every trip's.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.kernels.quant import corpus_reshape, dequantize, \
    quantize_int8
from repro_torch.retrieval import service
from repro_torch.serve import AsyncRetrievalEngine, EngineConfig, Request
from test_torch_threads import cap_torch_threads

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench.reference.maxsim import exhaustive_topk  # noqa: E402

cap_torch_threads()

pytestmark = pytest.mark.timeout(300)
T, L, M, C, K = 64, 45, 16, 512, 5


def _unit(x):
    return x / x.norm(dim=-1, keepdim=True)


def _corpus(C=C, L=L, M=M, min_len=None, seed=0):
    """Unit token rows around 8 topic directions; every page full unless
    ``min_len`` gives ragged lengths."""
    g = torch.Generator().manual_seed(seed)
    topics = _unit(torch.randn(8, M, generator=g))
    topic = torch.randint(0, 8, (C,), generator=g)
    embs = _unit(0.6 * topics[topic][:, None, :]
                 + torch.randn(C, L, M, generator=g))
    lens = (torch.full((C,), L) if min_len is None
            else torch.randint(min_len, L + 1, (C,), generator=g))
    mask = torch.arange(L)[None, :] < lens[:, None]
    return embs * mask[:, :, None], mask, topics


def _requests(topics, sizes=(200, 50) * 4, seed=1):
    """A request of ``sizes[i]`` candidates each: 50 and 200 fall in the
    buckets 64 and 256, so every bucket holds padded slots."""
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    out = []
    for i, n in enumerate(sizes):
        q = _unit(0.5 * topics[i % 8] + torch.randn(T, topics.shape[1],
                                                    generator=g))
        out.append((q.numpy(), rng.choice(C, n, replace=False)))
    return out


def _reference_cells(embs, mask, queries, cand):
    """(Q, T, M) queries, (Q, N) ids -> (Q, N, T) MaxSim cells, the
    reference's formula before its sum over tokens."""
    docs = embs[cand.clamp_min(0)]
    sims = torch.einsum("qtm,qnlm->qntl", queries, docs)
    sims = sims.masked_fill(~mask[cand.clamp_min(0)][:, :, None, :],
                            float("-inf"))
    return sims.amax(-1)


def _serve(embs, mask, reqs, **cfg):
    base = dict(batch_size=4, deadline_s=0.05, token_buckets=(T,),
                cand_buckets=(64, 256), max_k=K, flavor="bandit",
                bandit_min_candidates=64, pipeline_depth=2)
    base.update(cfg)
    eng = AsyncRetrievalEngine(embs, mask, EngineConfig(**base),
                               device="cpu")
    eng.warmup()
    eng.start()
    try:
        futs = [eng.future(eng.submit(Request(query=q, k=K, cand_ids=c)))
                for q, c in reqs]
        comps = [f.result(timeout=240) for f in futs]
    finally:
        eng.stop()
    assert all(c.error is None for c in comps)
    ref_embs = (embs if cfg.get("corpus_format", "bf16") == "bf16"
                else dequantize(eng.corpus_embs))
    return comps, ref_embs


def _held_to_reference(comps, reqs, embs, mask):
    for c, (q, cand) in zip(comps, reqs):
        cand_t = torch.as_tensor(cand, dtype=torch.long)[None]
        ids, top, _ = exhaustive_topk(embs, mask, torch.as_tensor(q)[None],
                                      cand_t, K)
        assert c.topk_ids.tolist() == ids[0].tolist()
        np.testing.assert_allclose(c.topk_scores, top[0].numpy(), rtol=0,
                                   atol=1e-5)


FORMATS = ["f32", "int8"]
BODIES = {"fused": "pooled_fused", "chain": "pooled_chain"}


def _fmt_kw(fmt):
    return {} if fmt == "f32" else {"corpus_format": "int8"}


@pytest.mark.parametrize("fmt", FORMATS)
def test_dense_pages_match_the_reference(fmt):
    embs, mask, topics = _corpus()
    reqs = _requests(topics)
    comps, ref = _serve(embs, mask, reqs, flavor="dense", **_fmt_kw(fmt))
    assert {c.flavor for c in comps} == {"dense"}
    _held_to_reference(comps, reqs, ref, mask)


@pytest.mark.parametrize("body", sorted(BODIES))
@pytest.mark.parametrize("fmt", FORMATS)
def test_bandit_revealing_every_page_cell_matches_the_reference(fmt, body):
    embs, mask, topics = _corpus()
    reqs = _requests(topics, sizes=(80, 50))
    # With the support this wide no hard bound separates a page before all
    # its cells are known, and with the round cap lifted a query stops when
    # no cell is left.
    comps, ref = _serve(embs, mask, reqs, alpha_ef=1e9, max_rounds=1 << 20,
                        support=(-1e4, 1e4), bandit_engine=BODIES[body],
                        **_fmt_kw(fmt))
    assert {c.flavor for c in comps} == {"bandit"}
    assert [c.reveal_fraction for c in comps] == [1.0] * len(comps)
    _held_to_reference(comps, reqs, ref, mask)


@pytest.mark.parametrize("body", sorted(BODIES))
@pytest.mark.parametrize("fmt", FORMATS)
def test_bandit_page_cells_are_the_reference_cells(fmt, body, monkeypatch):
    """Every cell a reveal launch returns for a real candidate is the
    reference's cell of that (query, candidate, token)."""
    embs, mask, topics = _corpus()
    reqs = _requests(topics)
    batches = []
    real = service._stacked_cells

    def spied(src, src_mask, queries, cand_ids=None):
        assert cand_ids is not None        # read in place, never gathered
        cells, cells_fused = real(src, src_mask, queries, cand_ids)
        launches = []
        batches.append((queries.clone(), cand_ids.clone(), launches))

        def c(flat_doc, flat_tok):
            vals = cells(flat_doc, flat_tok)
            launches.append((flat_doc.clone(), flat_tok.clone(), vals))
            return vals

        def cf(flat_doc, flat_tok, new_mask):
            vals, st = cells_fused(flat_doc, flat_tok, new_mask)
            launches.append((flat_doc.clone(), flat_tok.clone(), vals))
            return vals, st

        return c, cf

    monkeypatch.setattr(service, "_stacked_cells", spied)
    comps, ref = _serve(embs, mask, reqs, alpha_ef=0.2,
                        bandit_engine=BODIES[body], **_fmt_kw(fmt))
    assert 0.0 < min(c.reveal_fraction for c in comps) < 1.0
    checked = 0
    for queries, cand, launches in batches:
        (Q, N), flat_ids = cand.shape, cand.reshape(-1)
        want = _reference_cells(ref, mask, queries, cand)      # (Q, N, T)
        for flat_doc, flat_tok, vals in launches:
            q, i = flat_doc // N, flat_doc % N
            t = flat_tok - (q * T)[:, None]
            real_cand = (flat_ids[flat_doc] >= 0)[:, None] & (t >= 0) \
                & (t < T)
            assert q.max() < Q
            exp = want[q[:, None], i[:, None], t.clamp(0, T - 1)]
            torch.testing.assert_close(vals[real_cand], exp[real_cand],
                                       rtol=0, atol=1e-5)
            checked += int(real_cand.sum())
    assert checked > 0
    for c, (_, cand) in zip(comps, reqs):
        assert len(set(c.topk_ids.tolist())) == K
        assert set(c.topk_ids.tolist()) <= set(cand.tolist())


# ---------------------------------------------------------------------------
# resident corpus == gathered block, bit for bit; the reveal_rows counter
# ---------------------------------------------------------------------------

SHAPES = {
    # (T, L, ragged min length, N, corpus format)
    "text": (32, 24, 6, 64, "bf16"),
    "page": (64, 45, None, 64, "bf16"),
    "page-int8": (64, 45, None, 64, "int8"),
}


def _step_inputs(shape, B=3):
    Tq, Ld, min_len, N, fmt = SHAPES[shape]
    embs, mask, topics = _corpus(C=160, L=Ld, min_len=min_len, seed=3)
    if fmt == "int8":
        embs = quantize_int8(embs)
    g = torch.Generator().manual_seed(4)
    queries = _unit(0.5 * topics[torch.arange(B)][:, None, :]
                    + torch.randn(B, Tq, M, generator=g))
    cand = torch.stack([torch.randperm(160, generator=g)[:N]
                        for _ in range(B)])
    cand[0, 50:] = -1                      # padded slots
    cand[2, 7:] = -1
    a = torch.zeros((B, N, Tq))
    b = torch.ones((B, N, Tq))
    seeds = torch.arange(B, dtype=torch.int64) + 11
    return embs, mask, queries, cand, a, b, seeds


def _as_block_corpus(embs, mask, cand):
    """The gathered candidate block as a corpus of B*N rows, and the ids
    that read it (padded slots stay -1)."""
    B, N = cand.shape
    docs, dmask = service.gather_candidates(embs, mask, cand)
    ids = torch.arange(B * N, device=cand.device).reshape(B, N)
    return (corpus_reshape(docs, B * N), dmask.reshape(B * N, -1),
            torch.where(cand >= 0, ids, -1))


def _same(x, y):
    if isinstance(x, tuple):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            _same(u, v)
    else:
        assert torch.equal(x, y), (x, y)


class _LaunchRows:
    """Counts the frontier rows of every reveal launch of the steps."""

    def __init__(self, monkeypatch):
        self.rows = []
        for name in ("fused_reveal_op", "gather_maxsim_op"):
            real = getattr(service, name)

            def spy(*args, _real=real, **kw):
                self.rows.append(int(args[3].shape[0]))
                return _real(*args, **kw)

            monkeypatch.setattr(service, name, spy)


def _counted(fn):
    """Run ``fn`` with a batch's stamps open; (its result, the stamps)."""
    st = spans.new()
    prev = spans.open_batch(st)
    try:
        return fn(), st
    finally:
        spans.open_batch(prev)


@pytest.mark.parametrize("body", sorted(BODIES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_pooled_batch_step_reads_the_resident_corpus(shape, body,
                                                     monkeypatch):
    embs, mask, queries, cand, a, b, seeds = _step_inputs(shape)
    step = service.make_serving_step("bandit", topk=K, alpha_ef=0.2,
                                     engine=BODIES[body])
    launches = _LaunchRows(monkeypatch)
    got, st = _counted(lambda: step(embs, mask, queries, cand, a, b, seeds))
    rows = list(launches.rows)
    b_embs, b_mask, b_ids = _as_block_corpus(embs, mask, cand)
    want = step(b_embs, b_mask, queries, b_ids, a, b, seeds)
    scores, gids, frac, stats = want
    gids = torch.where(gids >= 0, cand.reshape(-1)[gids.clamp_min(0)], -1)
    _same(got, (scores, gids, frac, stats))
    assert float(frac.min()) < 1.0
    # The mesh steps' path over the gathered block agrees too.
    docs, dmask = service.gather_candidates(embs, mask, cand)
    old = service.ENGINES[BODIES[body]](
        docs, dmask, queries, cand, a, b, seeds,
        service._batched_config(K, 0.2, 0.01, 8, 8, -1, 0, 0))
    _same(got, old)
    Q, N = cand.shape
    assert rows[0] == Q * N and len(rows) - 1 == spans.counter(st, "trips")
    assert spans.counter(st, "reveal_rows") == sum(rows)


@pytest.mark.parametrize("body", sorted(BODIES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_streaming_step_reads_the_resident_corpus(shape, body, monkeypatch):
    embs, mask, queries, cand, a, b, seeds = _step_inputs(shape)
    B, N = cand.shape
    step = service.make_streaming_step(topk=K, alpha_ef=0.2, trip_limit=3,
                                       fused=body == "fused")
    b_embs, b_mask, b_ids = _as_block_corpus(embs, mask, cand)
    fresh = torch.ones((B,), dtype=torch.bool)
    s_res = s_blk = service.init_stream_state(B, N, queries.shape[1],
                                              device="cpu")
    for call in range(3):
        launches = _LaunchRows(monkeypatch)
        got, st = _counted(lambda: step(embs, mask, queries, cand, a, b,
                                        s_res, fresh, seeds))
        want = step(b_embs, b_mask, queries, b_ids, a, b, s_blk, fresh,
                    seeds)
        scores, gids, frac, stats, harvest, s_blk = want
        gids = torch.where(gids >= 0, cand.reshape(-1)[gids.clamp_min(0)],
                           -1)
        _same(got[:5], (scores, gids, frac, stats, harvest))
        _same(tuple(got[5]), tuple(s_blk))
        s_res = got[5]
        rows = launches.rows[:len(launches.rows) // 2]
        assert rows[0] == B * N
        assert len(rows) - 1 == spans.counter(st, "trips") <= 3
        assert spans.counter(st, "reveal_rows") == sum(rows)
        fresh = torch.zeros((B,), dtype=torch.bool)


@pytest.mark.parametrize("body", sorted(BODIES))
@pytest.mark.parametrize("growth", [dict(max_block_docs=16),
                                    dict(block_docs=16)])
def test_reveal_rows_count_every_launch(growth, body, monkeypatch):
    """With doc growth the trips launch the compacted frontier; with a
    block wider than the candidate list, fewer selection rows."""
    embs, mask, queries, cand, a, b, seeds = _step_inputs("text")
    cand = cand[:, :6].contiguous()
    a, b = a[:, :6], b[:, :6]
    cand[0, 4:] = -1
    step = service.make_serving_step("bandit", topk=2, alpha_ef=0.2,
                                     engine=BODIES[body], **growth)
    launches = _LaunchRows(monkeypatch)
    _, st = _counted(lambda: step(embs, mask, queries, cand, a, b, seeds))
    assert spans.counter(st, "trips") > 0
    assert spans.counter(st, "reveal_rows") == sum(launches.rows)


# ---------------------------------------------------------------------------
# on the card: the kernels read pages in place, bit for bit (run on the H100:
# pytest -m cuda tests/test_torch_page_widths.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the H100: pytest -m cuda "
                    "tests/test_torch_page_widths.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("body", sorted(BODIES))
@pytest.mark.parametrize("fmt", FORMATS)
def test_card_reads_pages_in_place_bit_for_bit(card, fmt, body):
    """Page widths on the card (T = 64, L = 729, M = 128, 4 queries x 256
    candidates with padded slots, a 2,048-page corpus): the batch step
    over the resident corpus equals the step over the gathered block."""
    g = torch.Generator(device=card).manual_seed(7)
    embs = _unit(torch.randn((2048, 729, 128), generator=g, device=card))
    mask = torch.ones((2048, 729), dtype=torch.bool, device=card)
    if fmt == "int8":
        embs = quantize_int8(embs)
    queries = _unit(torch.randn((4, 64, 128), generator=g, device=card))
    cand = torch.stack([torch.randperm(2048, generator=g, device=card)[:256]
                        for _ in range(4)])
    cand[1, 200:] = -1
    a = torch.zeros((4, 256, 64), device=card)
    b = torch.ones((4, 256, 64), device=card)
    seeds = torch.arange(4, dtype=torch.int64, device=card) + 5
    step = service.make_serving_step("bandit", topk=K, alpha_ef=0.2,
                                     engine=BODIES[body])
    got = step(embs, mask, queries, cand, a, b, seeds)
    b_embs, b_mask, b_ids = _as_block_corpus(embs, mask, cand)
    scores, gids, frac, stats = step(b_embs, b_mask, queries, b_ids, a, b,
                                     seeds)
    gids = torch.where(gids >= 0, cand.reshape(-1)[gids.clamp_min(0)], -1)
    _same(got, (scores, gids, frac, stats))
