"""Token-level corpus index (port of ``repro.retrieval.index``).

Documents are stored padded to a fixed L with a validity mask; the
flattened (C*L, M) token matrix drives the stage-1 per-query-token kNN.
The index lives on one device; the builders take numpy-convertible
arrays, so one numpy corpus feeds both this package and the JAX one.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass
class TokenIndex:
    doc_embs: torch.Tensor     # (C, L, M) f32
    doc_mask: torch.Tensor     # (C, L) bool
    doc_lens: torch.Tensor     # (C,) i64


def gather_tokens(embs: torch.Tensor, mask: torch.Tensor,
                  doc_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather candidate token embeddings by doc id (``retrieval/corpus.py``
    ``gather_tokens``): embs (C, L, M), mask (C, L), doc_ids (..., N) with
    -1 padding -> (..., N, L, M) embeddings + (..., N, L) mask, all-False
    for -1 ids."""
    safe = torch.clamp(doc_ids, min=0)
    docs = embs[safe]
    dmask = mask[safe] & (doc_ids >= 0)[..., None]
    return docs, dmask


def build_index(doc_embs, doc_mask, doc_lens, *,
                device="cuda") -> TokenIndex:
    """A float32 index on ``device`` from numpy-convertible arrays."""
    dev = torch.device(device)
    return TokenIndex(
        doc_embs=torch.tensor(np.asarray(doc_embs, np.float32), device=dev),
        doc_mask=torch.tensor(np.asarray(doc_mask, bool), device=dev),
        doc_lens=torch.tensor(np.asarray(doc_lens, np.int64), device=dev))


# The index of a numpy corpus (e.g. ``make_retrieval_dataset``'s arrays).
from_numpy = build_index


def from_arrays(obj, device="cuda") -> TokenIndex:
    """The index of anything with ``doc_embs``/``doc_mask``/``doc_lens``
    (a dataset, or another framework's index: each field goes through
    ``np.asarray``)."""
    return build_index(np.asarray(obj.doc_embs), np.asarray(obj.doc_mask),
                       np.asarray(obj.doc_lens), device=device)
