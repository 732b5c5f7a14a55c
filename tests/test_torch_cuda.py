"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips where ``torch.cuda.is_available()`` is
False. Run on the card with::

    python -m pytest -q -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance rtol=1e-5, atol=1e-6 for float32 and bf16 inputs alike (both are
upcast exactly and accumulated in float32; only the summation order of the
M-term dot products differs). This file imports no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import BanditConfig
from repro_torch.data.synthetic import make_retrieval_dataset
from repro_torch.kernels import _build
from repro_torch.kernels.gather_maxsim import gather_maxsim_cuda, \
    gather_maxsim_plain
from repro_torch.kernels.maxsim import maxsim_batch_cuda, maxsim_batch_plain
from repro_torch.kernels.reveal import fused_reveal_cuda, fused_reveal_plain
from repro_torch.retrieval.index import from_numpy
from repro_torch.retrieval.pipeline import serve_queries

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
    (3, 5, 77, 45, 100, torch.float32)])
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
