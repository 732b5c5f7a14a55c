"""Fused reveal round: one launch per pooled bandit round.

CUDA kernel ``csrc/reveal.cu`` (``colbandit_fused_reveal``) replaces the
TPU kernel ``src/repro/kernels/reveal.py:fused_reveal``
(``_fused_reveal_kernel``). For each frontier row f it gathers doc
``doc_idx[f]`` and the query rows ``tok_idx[f]`` inside the kernel and
returns the MaxSim values of the selected cells plus the row's
sufficient-statistic deltas over the fresh cells, so the caller's state
update is one scatter-min and one 3-column scatter-add. Bound on the H100:
device-memory bytes (G/2 flop per doc byte, far under the f32 ridge at the
serving path's G = 1 and 8); one block per row reads only its own doc's
valid tokens, all of a serving doc's rows in flight at once (``cp.async``
into two 64-token shared buffers; 128 threads and 32-token buffers for a
launch of more than 512 rows, such as the init reveal), and each thread
keeps a running max per cell in registers, so one shuffle tree per cell
runs at the end of the row. The block shape is a launch argument,
``block_l`` (64, 32, or 0 for the rule by launch size; see
``gather_maxsim.py``), chosen per shape bucket by ``kernels/tuning.py``. Each cell is one sequential FMA chain over M, the dense
``maxsim`` kernel's arithmetic, so the two kernels' cells are equal bit
for bit. The TPU layout's 8-lane stats padding is dropped: stats are
(F, 3).

``colbandit_fused_reveal_q`` (same source, same body) replaces the
quantized TPU kernel ``_fused_reveal_q_kernel``: on a ``QuantTokens``
corpus the block copies only int8 bytes, the row's scale and code into
shared memory and dequantizes each element in the dot (the residual
codebook is staged in shared memory once per block where it fits, up to
Kc ~390 at L = M = 128, and read from global memory above that). Bound on
the H100:
bytes (2*G flop per int8 byte). Its values equal ``colbandit_fused_reveal``
on the dequantized corpus, and ``colbandit_gather_maxsim_q`` on the same
corpus, bit for bit.

``fused_reveal_plain`` is the plain PyTorch version of both
(``kernels/ref.py``'s ``fused_reveal_ref``); its statistics come from
:func:`reveal_stats`, which sums in the kernel's own order.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_maxsim import check_gather_operands, \
    gather_maxsim_plain
from repro_torch.kernels.quant import QuantTokens


def reveal_stats(vals: torch.Tensor, new_mask: torch.Tensor) -> torch.Tensor:
    """Per-row deltas (F, 3) = [count, sum, sum of squares] over the
    ``new_mask`` cells of vals (F, G).

    Summed serially in ascending g with separately rounded products and
    sums, exactly as the CUDA kernel's thread 0 does, so the chain and fused
    round bodies and the kernel and its plain version agree bit for bit on
    identical values. ``vm * v`` (not ``new * v * v``) keeps an all-masked
    doc's -3e38 from squaring into inf and then NaN."""
    F, G = vals.shape
    vals = vals.to(torch.float32)
    cnt = torch.zeros((F,), dtype=torch.float32, device=vals.device)
    tot = torch.zeros_like(cnt)
    sq = torch.zeros_like(cnt)
    for g in range(G):
        fresh = new_mask[:, g]
        v = vals[:, g]
        vm = torch.where(fresh, v, 0.0)
        cnt = cnt + fresh.to(torch.float32)
        tot = tot + vm
        sq = sq + vm * v
    return torch.stack([cnt, tot, sq], dim=-1)


def fused_reveal_cuda(doc_embs: torch.Tensor, doc_tok_mask: torch.Tensor,
                      queries: torch.Tensor, doc_idx: torch.Tensor,
                      tok_idx: torch.Tensor, new_mask: torch.Tensor,
                      block_l: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """doc_embs (D, L, M), doc_tok_mask (D, L) bool, queries (TQ, M),
    doc_idx (F,) i64, tok_idx (F, G) i64, new_mask (F, G) bool ->
    (vals (F, G) f32, stats (F, 3) f32), on the card, at block shape
    ``block_l``."""
    _build.require(isinstance(doc_embs, torch.Tensor), "fused_reveal",
                   "a QuantTokens corpus goes to fused_reveal_q_cuda")
    return _launch("fused_reveal", doc_embs, doc_tok_mask, queries, doc_idx,
                   tok_idx, new_mask, block_l)


def fused_reveal_q_cuda(doc_embs: QuantTokens, doc_tok_mask: torch.Tensor,
                        queries: torch.Tensor, doc_idx: torch.Tensor,
                        tok_idx: torch.Tensor, new_mask: torch.Tensor,
                        block_l: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fused_reveal_cuda`` on a compressed corpus: doc_embs a
    ``QuantTokens`` with a (D, L, M) int8 payload."""
    _build.require(isinstance(doc_embs, QuantTokens), "fused_reveal_q",
                   "doc_embs must be a QuantTokens")
    return _launch("fused_reveal_q", doc_embs, doc_tok_mask, queries,
                   doc_idx, tok_idx, new_mask, block_l)


def _launch(name, doc_embs, doc_tok_mask, queries, doc_idx, tok_idx,
            new_mask, block_l):
    dev, corpus_args, e_bf16 = check_gather_operands(
        name, doc_embs, doc_tok_mask, queries, doc_idx, tok_idx, new_mask,
        block_l=block_l)
    _build.require(tuple(new_mask.shape) == tuple(tok_idx.shape)
                   and new_mask.dtype == torch.bool
                   and new_mask.is_contiguous(), name,
                   "new_mask must be a contiguous bool tensor shaped like "
                   "tok_idx")
    F, G = tok_idx.shape
    D, L, M = doc_embs.shape
    vals = torch.empty((F, G), dtype=torch.float32, device=dev)
    stats = torch.empty((F, 3), dtype=torch.float32, device=dev)
    if F == 0:
        return vals, stats
    lib = _build.library("reveal.cu")
    fn = getattr(lib, "colbandit_" + name)
    with torch.cuda.device(dev):
        status = fn(
            *corpus_args, doc_tok_mask.data_ptr(), queries.data_ptr(),
            doc_idx.data_ptr(), tok_idx.data_ptr(), new_mask.data_ptr(),
            vals.data_ptr(), stats.data_ptr(), F, G, L, M, D,
            queries.shape[0], e_bf16, int(queries.dtype == torch.bfloat16),
            block_l, _build.stream_ptr(dev))
    _build.check_launch(status, name)
    return vals, stats


def fused_reveal_plain(doc_embs, doc_tok_mask: torch.Tensor,
                       queries: torch.Tensor, doc_idx: torch.Tensor,
                       tok_idx: torch.Tensor, new_mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch fused reveal (``ref.fused_reveal_ref``): gathered
    MaxSim values plus :func:`reveal_stats` over the fresh cells.
    ``doc_embs`` may be a ``QuantTokens``."""
    vals = gather_maxsim_plain(doc_embs, doc_tok_mask, queries, doc_idx,
                               tok_idx)
    return vals, reveal_stats(vals, new_mask)
