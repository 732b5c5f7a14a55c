"""Public kernel ops (port of ``repro.kernels.ops`` for the serving path).

Dispatch is by the device of the operands, not by an environment variable:
CPU tensors take each kernel's plain PyTorch version, CUDA tensors launch
the hand-written kernel (or raise; nothing falls back). The CUDA kernels
mask ragged L and M themselves, so none of the TPU padding exists here.
Embeddings and queries may be float32 or bfloat16; every op accumulates
in float32 and returns float32. ``doc_embs`` may also be a compressed corpus
(``kernels.quant.QuantTokens``): dispatch then reads the device of every
leaf, a CPU corpus takes the plain version (which dequantizes), a CUDA one
launches the kernel's ``_q`` entry point, which dequantizes in the kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.gather_maxsim import gather_maxsim_cuda, \
    gather_maxsim_plain, gather_maxsim_q_cuda
from repro_torch.kernels.masked_maxsim import check_tiles, \
    masked_maxsim_cuda, masked_maxsim_plain, masked_maxsim_q_cuda
from repro_torch.kernels.maxsim import maxsim_batch_cuda, \
    maxsim_batch_plain, maxsim_batch_q_cuda, maxsim_plain
from repro_torch.kernels.quant import QuantTokens, corpus_leaves, \
    corpus_reshape
from repro_torch.kernels.reveal import fused_reveal_cuda, \
    fused_reveal_plain, fused_reveal_q_cuda


def _on_cuda(op: str, doc_embs, *tensors: torch.Tensor) -> bool:
    """Whether an op runs on the card: every leaf of the corpus operand and
    every other operand on CUDA (True) or on the CPU (False)."""
    kinds = {t.device.type for t in (*corpus_leaves(doc_embs), *tensors)}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"{op}: operands must all be on the CPU or all on CUDA, "
                     f"got {sorted(kinds)}")


def _idx(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64).contiguous()


def maxsim_op(doc_embs: torch.Tensor, doc_tok_mask: torch.Tensor,
              queries: torch.Tensor) -> torch.Tensor:
    """Dense MaxSim matrix H (N, T) from (N, L, M), (N, L), (T, M)."""
    if not _on_cuda("maxsim_op", doc_embs, doc_tok_mask, queries):
        return maxsim_plain(doc_embs, doc_tok_mask, queries)
    return maxsim_batch_op(corpus_reshape(doc_embs, 1, doc_embs.shape[0]),
                           doc_tok_mask[None], queries[None])[0]


def maxsim_scores_op(doc_embs: torch.Tensor, doc_tok_mask: torch.Tensor,
                     queries: torch.Tensor) -> torch.Tensor:
    """Full late-interaction scores S (N,) = sum_t H[:, t]. An all-masked
    doc's T >= 2 sentinels of -3e38 sum to -inf, as in JAX."""
    return maxsim_op(doc_embs, doc_tok_mask, queries).sum(-1)


def masked_maxsim_op(doc_embs: torch.Tensor, doc_tok_mask: torch.Tensor,
                     queries: torch.Tensor, tile_mask: torch.Tensor, *,
                     block_n: int = 8, block_t: int = 8) -> torch.Tensor:
    """Tile-masked MaxSim H (N, T) from (N, L, M), (N, L), (T, M): the
    MaxSim where the cell's (doc-block, token-block) tile is active,
    exactly 0 elsewhere. ``block_n``/``block_t`` are semantic: they define
    the grid ``tile_mask`` (ceil(N/block_n), ceil(T/block_t)) bool is
    written in. There is no ``block_l``: the CUDA kernels fix their own L
    tile. A malformed tile mask raises ValueError; it is never padded."""
    check_tiles("masked_maxsim_op", tile_mask, doc_embs.shape[0],
                queries.shape[0], block_n, block_t)
    if not _on_cuda("masked_maxsim_op", doc_embs, doc_tok_mask, queries,
                    tile_mask):
        return masked_maxsim_plain(doc_embs, doc_tok_mask, queries,
                                   tile_mask, block_n, block_t)
    quant = isinstance(doc_embs, QuantTokens)
    kernel = masked_maxsim_q_cuda if quant else masked_maxsim_cuda
    return kernel(doc_embs.contiguous(), doc_tok_mask.contiguous(),
                  queries.contiguous(), tile_mask.contiguous(), block_n,
                  block_t)


def maxsim_batch_op(doc_embs: torch.Tensor, doc_tok_mask: torch.Tensor,
                    queries: torch.Tensor) -> torch.Tensor:
    """Per-query-batched MaxSim H (B, N, T) — the dense serving scorer —
    from (B, N, L, M), (B, N, L), (B, T, M). No target materializes the
    (B, N, L, T) similarity tensor; all-masked docs give -3e38."""
    if not _on_cuda("maxsim_batch_op", doc_embs, doc_tok_mask, queries):
        return maxsim_batch_plain(doc_embs, doc_tok_mask, queries)
    quant = isinstance(doc_embs, QuantTokens)
    kernel = maxsim_batch_q_cuda if quant else maxsim_batch_cuda
    return kernel(doc_embs.contiguous(), doc_tok_mask.contiguous(),
                  queries.contiguous())


def gather_maxsim_op(doc_embs: torch.Tensor, doc_tok_mask: torch.Tensor,
                     queries: torch.Tensor, doc_idx: torch.Tensor,
                     tok_idx: torch.Tensor) -> torch.Tensor:
    """Gathered MaxSim for the bandit reveal: out[s, g] = max_j
    <E[doc_idx[s], j], Q[tok_idx[s, g]]> over valid j, (S,) x (S, G) ->
    (S, G). The pooled frontier passes query-offset ids into stacked
    (Q*N, L, M) / (Q*T, M) tensors; this op is oblivious to the stacking."""
    if doc_idx.shape[0] != tok_idx.shape[0]:
        raise ValueError(
            f"gather_maxsim_op: doc_idx has {doc_idx.shape[0]} rows but "
            f"tok_idx has {tok_idx.shape[0]} — every selection row needs "
            "one doc id and one token block")
    if not _on_cuda("gather_maxsim_op", doc_embs, doc_tok_mask, queries,
                    doc_idx, tok_idx):
        return gather_maxsim_plain(doc_embs, doc_tok_mask, queries, doc_idx,
                                   tok_idx)
    quant = isinstance(doc_embs, QuantTokens)
    kernel = gather_maxsim_q_cuda if quant else gather_maxsim_cuda
    return kernel(doc_embs.contiguous(), doc_tok_mask.contiguous(),
                  queries.contiguous(), _idx(doc_idx), _idx(tok_idx))


def fused_reveal_op(doc_embs: torch.Tensor, doc_tok_mask: torch.Tensor,
                    queries: torch.Tensor, doc_idx: torch.Tensor,
                    tok_idx: torch.Tensor, new_mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused reveal round: gathered MaxSim values for the frontier's
    selected cells plus the per-row sufficient-statistic deltas.

    doc_idx (F,), tok_idx (F, G), new_mask (F, G) ->
      (vals (F, G) f32, stats (F, 3) f32 = [d_count, d_total, d_total_sq])
    with the stats summed over the ``new_mask`` cells only."""
    if doc_idx.shape[0] != tok_idx.shape[0] \
            or tok_idx.shape != new_mask.shape:
        raise ValueError(
            f"fused_reveal_op: doc_idx/tok_idx/new_mask rows disagree "
            f"({doc_idx.shape[0]}, {tuple(tok_idx.shape)}, "
            f"{tuple(new_mask.shape)}) — every selection row needs one doc "
            "id and matching (G,) token and freshness columns")
    if not _on_cuda("fused_reveal_op", doc_embs, doc_tok_mask, queries,
                    doc_idx, tok_idx, new_mask):
        return fused_reveal_plain(doc_embs, doc_tok_mask, queries, doc_idx,
                                  tok_idx, new_mask)
    quant = isinstance(doc_embs, QuantTokens)
    kernel = fused_reveal_q_cuda if quant else fused_reveal_cuda
    return kernel(doc_embs.contiguous(), doc_tok_mask.contiguous(),
                  queries.contiguous(), _idx(doc_idx), _idx(tok_idx),
                  new_mask.contiguous())
