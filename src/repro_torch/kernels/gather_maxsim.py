"""Gathered MaxSim: the chain round body's reveal.

CUDA kernel ``csrc/reveal.cu`` (``colbandit_gather_maxsim``) replaces the
TPU kernel ``src/repro/kernels/gather_maxsim.py:gather_maxsim``
(``_gather_maxsim_kernel``): out[s, g] = max_l <E[doc_idx[s], l],
Q[tok_idx[s, g]]>. It is the fused reveal kernel's body with the
statistics compiled out, so the chain and fused round bodies read
bit-identical values. Bound on the H100: device-memory bytes, as for the
fused reveal; the JAX version gathered in XLA first, this one gathers
inside the kernel and never builds the (B, L, M) copy. One block per
frontier row compacts its doc's valid tokens, stages them into shared
memory 64 at a time with ``cp.async`` (two chunks in flight), and each
cell is one sequential FMA chain over M, so a cell equals the dense
``maxsim`` kernel's bit for bit. Any G runs: above 64 query rows a block
walks the rows in chunks of 64, restaging them and the doc for each. The
shared memory a launch needs comes from the kernel's own
``colbandit_reveal_smem_bytes``, the launch's layout: a residual codebook
too large to stage beside the rest is read from global memory instead, so
only the staged rows and the per-token lists (which grow with L and M) can
exceed a block's shared memory, and then the launch raises ValueError.
The block shape is a launch argument, ``block_l`` valid tokens per staged
chunk: 64 (256 threads), 32 (128 threads), or 0 for the rule by launch
size (32 above 512 frontier rows), chosen per shape bucket by
``kernels/tuning.py``; no cell depends on it.

``colbandit_gather_maxsim_q`` (same source, same body) replaces the
quantized TPU kernel ``_gather_maxsim_q_kernel``: on a ``QuantTokens``
corpus only int8 bytes, the row's scale and code are gathered; rows stay
int8 in shared memory and are dequantized by the loader's formula in the
dot. Bound on the H100: bytes (2*G flop per int8 byte, under the ridge
for G <= 8).

``gather_maxsim_plain`` is the plain PyTorch version of both
(``kernels/ref.py``'s ``gather_maxsim_ref``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant import QuantTokens, corpus_index, dense_rows

_NEG = -3e38
# Valid tokens per staged chunk of csrc/reveal.cu's block shapes (Wide,
# Narrow); 0 asks for the rule by launch size.
BLOCK_L = (64, 32)
NARROW_ROWS = 512


def reveal_block_l(F: int, block_l: int = 0) -> int:
    """The block_l a launch of F frontier rows runs at (the kernel's
    ``resolve_block_l``): ``block_l`` itself, or for 0 the rule by F."""
    if block_l == 0:
        return BLOCK_L[1] if F > NARROW_ROWS else BLOCK_L[0]
    return block_l


def check_block_l(name: str, block_l) -> int:
    """``block_l`` as an int, or ValueError where it names no block shape
    of the kernel (never a quiet fall back to the default)."""
    _build.require(isinstance(block_l, int)
                   and (block_l == 0 or block_l in BLOCK_L), name,
                   f"block_l={block_l!r} is not 0 (by launch size) or one of "
                   f"the kernel's block shapes {BLOCK_L}")
    return block_l


def check_gather_operands(name: str, doc_embs, doc_tok_mask, queries,
                          doc_idx, tok_idx, *extra, block_l: int = 0):
    """Validate the shared operands of the gathered-MaxSim kernels, to be
    launched at ``block_l``; ``doc_embs`` is a float tensor or a
    ``QuantTokens``. Returns the device and the C arguments of the corpus:
    ([E], e_bf16) for a float tensor, ([data, scales, codes, codebook,
    Kc], s_bf16) for a ``QuantTokens``."""
    check_block_l(name, block_l)
    quant = isinstance(doc_embs, QuantTokens)
    leaves = ([a for a in doc_embs if a is not None] if quant
              else [doc_embs])
    dev = _build.require_cuda(name, *leaves, doc_tok_mask, queries, doc_idx,
                              tok_idx, *extra)
    if quant:
        corpus_args, e_bf16 = _build.quant_args(name, doc_embs)
        kc = corpus_args[-1]
    else:
        _build.require(doc_embs.dtype in _build.FLOAT_TYPES
                       and doc_embs.is_contiguous(), name,
                       "doc_embs must be contiguous float32/bfloat16")
        corpus_args = [doc_embs.data_ptr()]
        e_bf16, kc = int(doc_embs.dtype == torch.bfloat16), 0
    _build.require(len(doc_embs.shape) == 3 and doc_tok_mask.dim() == 2
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
    _build.require(queries.dtype in _build.FLOAT_TYPES
                   and doc_tok_mask.dtype == torch.bool
                   and doc_idx.dtype == torch.int64
                   and tok_idx.dtype == torch.int64, name,
                   "queries must be float32/bfloat16, the mask bool, "
                   "the indices int64")
    _build.require(all(t.is_contiguous() for t in (
        doc_tok_mask, queries, doc_idx, tok_idx)), name,
        "operands must be contiguous")
    G = tok_idx.shape[1]
    _build.require(doc_idx.shape[0] < 2 ** 31, name,
                   f"{doc_idx.shape[0]} frontier rows exceed the grid")
    esz = 1 if quant else doc_embs.element_size()
    smem = _build.library("reveal.cu").colbandit_reveal_smem_bytes(
        doc_idx.shape[0], G, L, M, esz, int(quant), kc, block_l)
    _build.require(smem <= _build.SHARED_MEM_BYTES, name,
                   f"L={L}, M={M}: the staged doc rows and per-token lists "
                   f"of a block need {smem} bytes of shared memory, more "
                   f"than the card's {_build.SHARED_MEM_BYTES} a block "
                   f"(a codebook, Kc={kc}, is not staged where it does "
                   "not fit)")
    return dev, corpus_args, e_bf16


def gather_maxsim_cuda(doc_embs: torch.Tensor, doc_tok_mask: torch.Tensor,
                       queries: torch.Tensor, doc_idx: torch.Tensor,
                       tok_idx: torch.Tensor, block_l: int = 0
                       ) -> torch.Tensor:
    """doc_embs (D, L, M), doc_tok_mask (D, L) bool, queries (TQ, M),
    doc_idx (F,) i64, tok_idx (F, G) i64 -> (F, G) f32, on the card, at
    block shape ``block_l``."""
    _build.require(isinstance(doc_embs, torch.Tensor), "gather_maxsim",
                   "a QuantTokens corpus goes to gather_maxsim_q_cuda")
    return _launch("gather_maxsim", doc_embs, doc_tok_mask, queries, doc_idx,
                   tok_idx, block_l)


def gather_maxsim_q_cuda(doc_embs: QuantTokens, doc_tok_mask: torch.Tensor,
                         queries: torch.Tensor, doc_idx: torch.Tensor,
                         tok_idx: torch.Tensor, block_l: int = 0
                         ) -> torch.Tensor:
    """``gather_maxsim_cuda`` on a compressed corpus: doc_embs a
    ``QuantTokens`` with a (D, L, M) int8 payload."""
    _build.require(isinstance(doc_embs, QuantTokens), "gather_maxsim_q",
                   "doc_embs must be a QuantTokens")
    return _launch("gather_maxsim_q", doc_embs, doc_tok_mask, queries,
                   doc_idx, tok_idx, block_l)


def _launch(name, doc_embs, doc_tok_mask, queries, doc_idx, tok_idx,
            block_l):
    dev, corpus_args, e_bf16 = check_gather_operands(
        name, doc_embs, doc_tok_mask, queries, doc_idx, tok_idx,
        block_l=block_l)
    F, G = tok_idx.shape
    D, L, M = doc_embs.shape
    out = torch.empty((F, G), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.library("reveal.cu")
    fn = getattr(lib, "colbandit_" + name)
    with torch.cuda.device(dev):
        status = fn(
            *corpus_args, doc_tok_mask.data_ptr(), queries.data_ptr(),
            doc_idx.data_ptr(), tok_idx.data_ptr(), out.data_ptr(), F, G, L,
            M, D, queries.shape[0], e_bf16,
            int(queries.dtype == torch.bfloat16), block_l,
            _build.stream_ptr(dev))
    _build.check_launch(status, name)
    return out


def gather_maxsim_plain(doc_embs, doc_tok_mask: torch.Tensor,
                        queries: torch.Tensor, doc_idx: torch.Tensor,
                        tok_idx: torch.Tensor) -> torch.Tensor:
    """H[doc_idx[s], tok_idx[s, g]] for the selected cells only
    (``ref.gather_maxsim_ref``); ``doc_embs`` may be a ``QuantTokens``,
    gathered leaf-wise and then dequantized."""
    e = dense_rows(corpus_index(doc_embs, doc_idx))      # (F, L, M)
    m = doc_tok_mask[doc_idx]                            # (F, L)
    q = queries[tok_idx].to(torch.float32)               # (F, G, M)
    sims = torch.einsum("blm,bgm->blg", e, q)
    sims = torch.where(m[:, :, None], sims, _NEG)
    return sims.max(dim=1).values
