"""Tile-masked MaxSim: H only for the active (doc-block, token-block) tiles
of a tile mask, exactly 0 elsewhere.

CUDA kernel ``csrc/maxsim.cu`` (``colbandit_masked_maxsim``) replaces the
TPU kernel ``src/repro/kernels/masked_maxsim.py:97`` ``masked_maxsim``
(``_masked_maxsim_kernel``, ``:27``); ``colbandit_masked_maxsim_q``
replaces ``_masked_maxsim_q_kernel`` (``:56``), which reads a
``QuantTokens`` corpus and skips the dequant of inactive tiles too. Both run
the dense MaxSim body of ``csrc/maxsim.cu`` (``maxsim.py``'s kernels) with
the tile mask as an operand: a block of docs with no active tile writes
zeros without reading its tokens, a doc with no active tile in a 32-token
query pass is neither staged nor computed in it, a warp skips a 16-row
query half with no active tile, and every active cell equals the dense
kernel's bit for bit (the same fmaf chain per cell). Bound on the H100: as
the dense kernel over the docs it reads (bytes and the f32 issue rate for
f32, operations for int8); the design notes are in the source. The shared
memory a launch needs is the dense body's (``colbandit_maxsim_smem_bytes``):
a codebook too large to stage is read from global memory, and a doc length
whose token lists do not fit raises ValueError before any launch.

``tile_mask`` is (ceil(N / block_n), ceil(T / block_t)) bool: ``block_n``
and ``block_t`` define the grid it is written in and do not tune anything.
The CUDA kernels fix their own L chunk, so there is no ``block_l``.

``masked_maxsim_plain`` is the plain PyTorch version of both
(``kernels/ref.py``'s ``masked_maxsim_ref``); tests and ``chip_smoke.py``
compare the kernels with it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.maxsim import MASKED_DOCS, _check_maxsim, \
    _dense_smem, maxsim_plain
from repro_torch.kernels.quant import QuantTokens, corpus_reshape


def check_tiles(name: str, tile_mask: torch.Tensor, N: int, T: int,
                block_n: int, block_t: int) -> None:
    """Raise ValueError unless ``tile_mask`` is a bool tensor shaped
    (ceil(N / block_n), ceil(T / block_t)) with both blocks >= 1."""
    _build.require(block_n >= 1 and block_t >= 1, name,
                   f"block_n and block_t must be >= 1, got {block_n}, "
                   f"{block_t}")
    _build.require(isinstance(tile_mask, torch.Tensor)
                   and tile_mask.dtype == torch.bool, name,
                   "tile_mask must be a bool tensor, got "
                   f"{getattr(tile_mask, 'dtype', type(tile_mask))}")
    want = (-(-N // block_n), -(-T // block_t))
    _build.require(tuple(tile_mask.shape) == want, name,
                   f"tile_mask must be (ceil(N/block_n), ceil(T/block_t)) = "
                   f"{want}, got {tuple(tile_mask.shape)}")


def masked_maxsim_plain(doc_embs, doc_tok_mask: torch.Tensor,
                        queries: torch.Tensor, tile_mask: torch.Tensor,
                        block_n: int, block_t: int) -> torch.Tensor:
    """Tile-masked MaxSim (``ref.masked_maxsim_ref``): (N, L, M), (N, L),
    (T, M) and a (ceil(N/block_n), ceil(T/block_t)) bool tile mask ->
    (N, T) f32, the dense MaxSim where the cell's tile is active and exactly
    0 elsewhere. ``doc_embs`` may be a ``QuantTokens``."""
    h = maxsim_plain(doc_embs, doc_tok_mask, queries)
    full = tile_mask.repeat_interleave(block_n, 0) \
        .repeat_interleave(block_t, 1)
    return torch.where(full[:h.shape[0], :h.shape[1]], h, 0.0)


def _launch(name, fn, corpus_args, e_flag, doc_tok_mask, queries,
            tile_mask, block_n, block_t, out):
    """Launch one masked entry point on checked operands: ``corpus_args``
    are its leading corpus arguments, ``e_flag`` its corpus dtype flag."""
    (N, L), (T, M) = doc_tok_mask.shape, queries.shape
    _build.require(tile_mask.is_contiguous(), name,
                   "tile_mask must be contiguous")
    _build.require(max(block_n, block_t) < 2 ** 31, name,
                   f"block_n, block_t = {block_n}, {block_t} exceed a C int")
    dev = out.device
    with torch.cuda.device(dev):
        status = fn(*corpus_args, doc_tok_mask.data_ptr(), queries.data_ptr(),
                    tile_mask.data_ptr(), out.data_ptr(), N, L, M, T, block_n,
                    block_t, e_flag, int(queries.dtype == torch.bfloat16),
                    _build.stream_ptr(dev))
    _build.check_launch(status, name)
    return out


def masked_maxsim_cuda(doc_embs: torch.Tensor, doc_tok_mask: torch.Tensor,
                       queries: torch.Tensor, tile_mask: torch.Tensor,
                       block_n: int, block_t: int) -> torch.Tensor:
    """H (N, T) f32 from doc_embs (N, L, M) float32/bf16, doc_tok_mask
    (N, L) bool, queries (T, M) and a bool tile mask, on the card: the
    MaxSim where the tile is active (-3e38 for an all-masked doc), exactly
    0 elsewhere."""
    name = "masked_maxsim"
    _build.require(isinstance(doc_embs, torch.Tensor), name,
                   "a QuantTokens corpus goes to masked_maxsim_q_cuda")
    _build.require(doc_embs.dim() == 3 and doc_tok_mask.dim() == 2
                   and queries.dim() == 2, name,
                   "expected doc_embs (N,L,M), doc_tok_mask (N,L), "
                   "queries (T,M)")
    N = doc_embs.shape[0]
    check_tiles(name, tile_mask, N, queries.shape[0], block_n, block_t)
    _build.require_cuda(name, doc_embs, doc_tok_mask, queries, tile_mask)
    _build.require(doc_embs.dtype in _build.FLOAT_TYPES
                   and doc_embs.is_contiguous(), name,
                   "doc_embs must be contiguous float32/bfloat16")
    out = _check_maxsim(name, doc_embs[None], doc_tok_mask[None],
                        queries[None],
                        _dense_smem(doc_embs.element_size(),
                                    docs=MASKED_DOCS))[0]
    if out.numel() == 0:
        return out
    lib = _build.library("maxsim.cu")
    return _launch(name, lib.colbandit_masked_maxsim, [doc_embs.data_ptr()],
                   int(doc_embs.dtype == torch.bfloat16), doc_tok_mask,
                   queries, tile_mask, block_n, block_t, out)


def masked_maxsim_q_cuda(doc_embs: QuantTokens, doc_tok_mask: torch.Tensor,
                         queries: torch.Tensor, tile_mask: torch.Tensor,
                         block_n: int, block_t: int) -> torch.Tensor:
    """``masked_maxsim_cuda`` on a compressed corpus: doc_embs a
    ``QuantTokens`` with an (N, L, M) int8 payload, (N, L) scales (and
    codes) and a (Kc, M) codebook for the residual format. Inactive tiles
    skip the dequant as well as the product."""
    name = "masked_maxsim_q"
    _build.require(isinstance(doc_embs, QuantTokens), name,
                   "doc_embs must be a QuantTokens")
    _build.require(doc_embs.ndim == 3 and doc_tok_mask.dim() == 2
                   and queries.dim() == 2, name,
                   "expected doc_embs (N,L,M), doc_tok_mask (N,L), "
                   "queries (T,M)")
    N, M = doc_embs.shape[0], doc_embs.shape[-1]
    check_tiles(name, tile_mask, N, queries.shape[0], block_n, block_t)
    _build.require_cuda(name, *(a for a in doc_embs if a is not None),
                        doc_tok_mask, queries, tile_mask)
    qargs, s_bf16 = _build.quant_args(name, doc_embs)
    out = _check_maxsim(name, corpus_reshape(doc_embs, 1, N),
                        doc_tok_mask[None], queries[None],
                        _dense_smem(1, qargs[-1], scaled=True,
                                    docs=MASKED_DOCS))[0]
    if out.numel() == 0:
        return out
    lib = _build.library("maxsim.cu")
    return _launch(name, lib.colbandit_masked_maxsim_q, qargs, s_bf16,
                   doc_tok_mask, queries, tile_mask, block_n, block_t, out)
