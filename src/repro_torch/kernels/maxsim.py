"""Dense MaxSim: the dense rerank flavor's scorer and the exhaustive oracle.

CUDA kernel ``csrc/maxsim.cu`` (``colbandit_maxsim``) replaces the TPU
kernel ``src/repro/kernels/maxsim.py:maxsim`` (``_maxsim_kernel``), which
``ops.maxsim_batch_op`` vmapped over the query batch; here the batch is a
grid axis of one launch. Bound on the H100: device-memory bytes and the
f32 issue rate about equally at T = 32, M = 128 (16 flop per doc byte
against a ridge of ~20); the design notes are in the source. The
(B, N, L, T) similarity tensor is never built.

``maxsim_batch_plain`` is the plain PyTorch version (``kernels/ref.py``'s
``maxsim_batch_ref``: an L-chunked running max, again without the
(B, N, L, T) tensor). Tests and ``chip_smoke.py`` compare the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_NEG = -3e38


def maxsim_batch_cuda(doc_embs: torch.Tensor, doc_tok_mask: torch.Tensor,
                      queries: torch.Tensor) -> torch.Tensor:
    """H (B, N, T) f32 from doc_embs (B, N, L, M), doc_tok_mask (B, N, L)
    bool and queries (B, T, M), on the card. f32 or bf16 inputs, f32
    accumulation; -3e38 for an all-masked doc."""
    name = "maxsim"
    dev = _build.require_cuda(name, doc_embs, doc_tok_mask, queries)
    _build.require(doc_embs.dim() == 4 and queries.dim() == 3
                   and doc_tok_mask.dim() == 3, name,
                   "expected doc_embs (B,N,L,M), doc_tok_mask (B,N,L), "
                   "queries (B,T,M)")
    B, N, L, M = doc_embs.shape
    T = queries.shape[1]
    _build.require(tuple(doc_tok_mask.shape) == (B, N, L)
                   and queries.shape[0] == B and queries.shape[2] == M,
                   name, f"shape mismatch: {tuple(doc_embs.shape)}, "
                   f"{tuple(doc_tok_mask.shape)}, {tuple(queries.shape)}")
    _build.require(doc_embs.dtype in _build.FLOAT_TYPES
                   and queries.dtype in _build.FLOAT_TYPES
                   and doc_tok_mask.dtype == torch.bool, name,
                   "embeddings must be float32/bfloat16, the mask bool")
    _build.require(doc_embs.is_contiguous() and queries.is_contiguous()
                   and doc_tok_mask.is_contiguous(), name,
                   "operands must be contiguous")
    _build.require(B <= 65535 and N < 2 ** 31 and M * 64 * 4 + 1024
                   <= 227 * 1024, name, f"unsupported sizes B={B}, N={N}, "
                   f"M={M}")
    out = torch.empty((B, N, T), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.library("maxsim.cu")
    with torch.cuda.device(dev):
        status = lib.colbandit_maxsim(
            doc_embs.data_ptr(), doc_tok_mask.data_ptr(), queries.data_ptr(),
            out.data_ptr(), B, N, L, M, T,
            int(doc_embs.dtype == torch.bfloat16),
            int(queries.dtype == torch.bfloat16), _build.stream_ptr(dev))
    _build.check_launch(status, name)
    return out


def maxsim_plain(doc_embs: torch.Tensor, doc_tok_mask: torch.Tensor,
                 queries: torch.Tensor) -> torch.Tensor:
    """Dense MaxSim matrix (Eq. 4): (N, L, M), (N, L), (T, M) -> (N, T) f32,
    H[i, t] = max_j <e_ij, q_t> over valid j (``ref.maxsim_ref``)."""
    sims = torch.einsum("nlm,tm->nlt", doc_embs.to(torch.float32),
                        queries.to(torch.float32))
    sims = torch.where(doc_tok_mask[:, :, None], sims, _NEG)
    return sims.max(dim=1).values


def maxsim_batch_plain(doc_embs: torch.Tensor, doc_tok_mask: torch.Tensor,
                       queries: torch.Tensor, *,
                       block_l: int = 64) -> torch.Tensor:
    """Per-query-batched MaxSim streamed over document tokens
    (``ref.maxsim_batch_ref``): (B, N, L, M), (B, N, L), (B, T, M) ->
    (B, N, T). The peak temporary is (B, N, block_l, T)."""
    Bq, N, L, _ = doc_embs.shape
    T = queries.shape[1]
    q = queries.to(torch.float32)
    h = torch.full((Bq, N, T), _NEG, dtype=torch.float32,
                   device=doc_embs.device)
    for l0 in range(0, L, max(block_l, 1)):
        e_c = doc_embs[:, :, l0:l0 + block_l].to(torch.float32)
        m_c = doc_tok_mask[:, :, l0:l0 + block_l]
        sims = torch.einsum("bnlm,btm->bnlt", e_c, q)
        sims = torch.where(m_c[..., None], sims, _NEG)
        h = torch.maximum(h, sims.max(dim=2).values)
    return h
