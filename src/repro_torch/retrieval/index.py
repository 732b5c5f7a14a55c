"""Token-level corpus index (port of ``repro.retrieval.index``).

Documents are stored padded to a fixed L with a validity mask; the
flattened (C*L, M) token matrix drives the stage-1 per-query-token kNN.
The index lives on one device; the builders take numpy-convertible
arrays, so one numpy corpus feeds both this package and the JAX one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.retrieval.corpus import gather_tokens

__all__ = ["TokenIndex", "build_index", "build_index_from_ragged",
           "from_numpy", "from_arrays", "gather_tokens"]


@dataclasses.dataclass
class TokenIndex:
    doc_embs: torch.Tensor     # (C, L, M) f32
    doc_mask: torch.Tensor     # (C, L) bool
    doc_lens: torch.Tensor     # (C,) i64

    @property
    def n_docs(self) -> int:
        return self.doc_embs.shape[0]

    @property
    def max_len(self) -> int:
        return self.doc_embs.shape[1]

    @property
    def dim(self) -> int:
        return self.doc_embs.shape[2]

    def flat_tokens(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(C*L, M) token matrix + (C*L,) int32 owning-doc ids (invalid
        tokens -1)."""
        C, L, M = self.doc_embs.shape
        toks = self.doc_embs.reshape(C * L, M)
        owner = torch.arange(C, dtype=torch.int32,
                             device=self.doc_mask.device).repeat_interleave(L)
        return toks, torch.where(self.doc_mask.reshape(-1), owner, -1)

    def gather_docs(self, doc_ids: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Candidate sub-index: (..., N, L, M) embeddings + (..., N, L)
        mask of ``doc_ids`` (..., N). Negative ids are padding and come
        back fully masked."""
        return gather_tokens(self.doc_embs, self.doc_mask, doc_ids)


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


def build_index_from_ragged(docs: Sequence[np.ndarray],
                            pad_to: Optional[int] = None, *,
                            device="cuda") -> TokenIndex:
    """Pack a ragged list of (L_i, M) token arrays into a padded index on
    ``device``: L = ``pad_to`` or the longest doc, longer docs cut to L."""
    lens = np.asarray([d.shape[0] for d in docs], np.int32)
    L = int(pad_to or lens.max())
    M = docs[0].shape[1]
    out = np.zeros((len(docs), L, M), np.float32)
    mask = np.zeros((len(docs), L), bool)
    for i, d in enumerate(docs):
        n = min(d.shape[0], L)
        out[i, :n] = d[:n]
        mask[i, :n] = True
    return build_index(out, mask, np.minimum(lens, L), device=device)


def from_arrays(obj, device="cuda") -> TokenIndex:
    """The index of anything with ``doc_embs``/``doc_mask``/``doc_lens``
    (a dataset, or another framework's index: each field goes through
    ``np.asarray``)."""
    return build_index(np.asarray(obj.doc_embs), np.asarray(obj.doc_mask),
                       np.asarray(obj.doc_lens), device=device)
