"""Gathered MaxSim: the chain round body's reveal.

CUDA kernel ``csrc/reveal.cu`` (``colbandit_gather_maxsim``) replaces the
TPU kernel ``src/repro/kernels/gather_maxsim.py:gather_maxsim``
(``_gather_maxsim_kernel``): out[s, g] = max_l <E[doc_idx[s], l],
Q[tok_idx[s, g]]>. It is the fused reveal kernel's body with the
statistics compiled out, so the chain and fused round bodies read
bit-identical values. Bound on the H100: device-memory bytes, as for the
fused reveal; the JAX version gathered in XLA first, this one gathers
inside the kernel and never builds the (B, L, M) copy.

``gather_maxsim_plain`` is the plain PyTorch version
(``kernels/ref.py``'s ``gather_maxsim_ref``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_NEG = -3e38


def check_gather_operands(name: str, doc_embs, doc_tok_mask, queries,
                          doc_idx, tok_idx, *extra) -> torch.device:
    """Validate the shared operands of the two gathered-MaxSim kernels."""
    dev = _build.require_cuda(name, doc_embs, doc_tok_mask, queries, doc_idx,
                              tok_idx, *extra)
    _build.require(doc_embs.dim() == 3 and doc_tok_mask.dim() == 2
                   and queries.dim() == 2 and doc_idx.dim() == 1
                   and tok_idx.dim() == 2, name,
                   "expected doc_embs (D,L,M), doc_tok_mask (D,L), queries "
                   "(TQ,M), doc_idx (F,), tok_idx (F,G)")
    D, L, M = doc_embs.shape
    _build.require(tuple(doc_tok_mask.shape) == (D, L)
                   and queries.shape[1] == M
                   and tok_idx.shape[0] == doc_idx.shape[0], name,
                   f"shape mismatch: {tuple(doc_embs.shape)}, "
                   f"{tuple(doc_tok_mask.shape)}, {tuple(queries.shape)}, "
                   f"{tuple(doc_idx.shape)}, {tuple(tok_idx.shape)}")
    _build.require(D > 0 and queries.shape[0] > 0, name,
                   "empty corpus or query table")
    _build.require(doc_embs.dtype in _build.FLOAT_TYPES
                   and queries.dtype in _build.FLOAT_TYPES
                   and doc_tok_mask.dtype == torch.bool
                   and doc_idx.dtype == torch.int64
                   and tok_idx.dtype == torch.int64, name,
                   "embeddings must be float32/bfloat16, the mask bool, "
                   "the indices int64")
    _build.require(all(t.is_contiguous() for t in (
        doc_embs, doc_tok_mask, queries, doc_idx, tok_idx)), name,
        "operands must be contiguous")
    G = tok_idx.shape[1]
    smem = (G * M + 8 * M + 8 * G + G) * 4
    _build.require(doc_idx.shape[0] < 2 ** 31 and smem <= 227 * 1024, name,
                   f"G={G}, M={M} need {smem} bytes of shared memory")
    return dev


def gather_maxsim_cuda(doc_embs: torch.Tensor, doc_tok_mask: torch.Tensor,
                       queries: torch.Tensor, doc_idx: torch.Tensor,
                       tok_idx: torch.Tensor) -> torch.Tensor:
    """doc_embs (D, L, M), doc_tok_mask (D, L) bool, queries (TQ, M),
    doc_idx (F,) i64, tok_idx (F, G) i64 -> (F, G) f32, on the card."""
    name = "gather_maxsim"
    dev = check_gather_operands(name, doc_embs, doc_tok_mask, queries,
                                doc_idx, tok_idx)
    F, G = tok_idx.shape
    D, L, M = doc_embs.shape
    out = torch.empty((F, G), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.library("reveal.cu")
    with torch.cuda.device(dev):
        status = lib.colbandit_gather_maxsim(
            doc_embs.data_ptr(), doc_tok_mask.data_ptr(), queries.data_ptr(),
            doc_idx.data_ptr(), tok_idx.data_ptr(), out.data_ptr(), F, G, L,
            M, D, queries.shape[0], int(doc_embs.dtype == torch.bfloat16),
            int(queries.dtype == torch.bfloat16), _build.stream_ptr(dev))
    _build.check_launch(status, name)
    return out


def gather_maxsim_plain(doc_embs: torch.Tensor, doc_tok_mask: torch.Tensor,
                        queries: torch.Tensor, doc_idx: torch.Tensor,
                        tok_idx: torch.Tensor) -> torch.Tensor:
    """H[doc_idx[s], tok_idx[s, g]] for the selected cells only
    (``ref.gather_maxsim_ref``)."""
    e = doc_embs[doc_idx].to(torch.float32)              # (F, L, M)
    m = doc_tok_mask[doc_idx]                            # (F, L)
    q = queries[tok_idx].to(torch.float32)               # (F, G, M)
    sims = torch.einsum("blm,bgm->blg", e, q)
    sims = torch.where(m[:, :, None], sims, _NEG)
    return sims.max(dim=1).values
