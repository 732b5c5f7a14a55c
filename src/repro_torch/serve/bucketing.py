"""Static shape buckets for the serving steps (port of
``repro.serve.bucketing``; host numpy, the same code).

A serving engine pads every admitted batch into a small set of static
shapes: query-token counts round up to one of ``token_buckets`` and
candidate counts to one of ``cand_buckets``. Fixed shapes let one warmed
program (a CUDA graph or a tuned launch configuration) serve each bucket
instead of whatever shapes the traffic brings, so at most
``len(token_buckets) * len(cand_buckets)`` of them exist per step flavor
and all can be warmed before traffic arrives.

All padding here is host-side numpy (zeros for embeddings, -1 for candidate
ids, zero-width [0, 0] support for padded cells): padded cells carry no
score mass and padded docs are masked out of every selection.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ShapeBuckets:
    """Ascending, deduplicated shape buckets for tokens and candidates."""

    token_buckets: Tuple[int, ...]
    cand_buckets: Tuple[int, ...]

    def __post_init__(self):
        for name in ("token_buckets", "cand_buckets"):
            vals = tuple(sorted(set(int(v) for v in getattr(self, name))))
            if not vals or vals[0] < 1:
                raise ValueError(f"{name} must be non-empty and positive")
            object.__setattr__(self, name, vals)

    @staticmethod
    def _fit(buckets: Tuple[int, ...], x: int, what: str) -> int:
        for b in buckets:
            if x <= b:
                return b
        raise ValueError(f"{what}={x} exceeds the largest bucket "
                         f"{buckets[-1]}; raise the bucket config")

    def token_bucket(self, n_tokens: int) -> int:
        """Smallest token bucket that fits ``n_tokens``."""
        return self._fit(self.token_buckets, n_tokens, "query tokens")

    def cand_bucket(self, n_cands: int) -> int:
        """Smallest candidate bucket that fits ``n_cands``."""
        return self._fit(self.cand_buckets, n_cands, "candidates")

    def all_buckets(self) -> List[Tuple[int, int]]:
        """Every (token_bucket, cand_bucket) combination, for warmup."""
        return [(t, c) for t in self.token_buckets
                for c in self.cand_buckets]


def pad_queries(queries: Sequence[np.ndarray], t_bucket: int) -> np.ndarray:
    """Stack variable-length (T_i, M) queries into (B, t_bucket, M), zero
    padded. Zero query tokens dot to exactly 0 against every doc token, so
    they add nothing to any MaxSim score."""
    m = queries[0].shape[-1]
    out = np.zeros((len(queries), t_bucket, m), np.float32)
    for i, q in enumerate(queries):
        t = q.shape[0]
        if t > t_bucket:
            raise ValueError(f"query has {t} tokens > bucket {t_bucket}")
        out[i, :t] = q
    return out


def pad_candidates(cand_ids: Sequence[Optional[np.ndarray]],
                   n_bucket: int) -> np.ndarray:
    """Stack candidate id lists into (B, n_bucket) int32, -1 padded.
    ``None`` entries become all -1 rows (filled by stage-1 downstream)."""
    out = np.full((len(cand_ids), n_bucket), -1, np.int32)
    for i, c in enumerate(cand_ids):
        if c is None:
            continue
        c = np.asarray(c, np.int32)
        if c.shape[0] > n_bucket:
            raise ValueError(f"{c.shape[0]} candidates > bucket {n_bucket}")
        out[i, :c.shape[0]] = c
    return out


def support_bounds(cand: np.ndarray, n_tokens: Sequence[int], t_bucket: int,
                   support: Tuple[float, float]) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """Generic per-cell support [a, b] for a padded candidate batch.

    Real (doc, token) cells get the global similarity support; padded docs
    and padded query-token columns get the zero-width [0, 0] interval, so
    the bandit never spends reveals on them and hard bounds stay exact.
    """
    b_sz, n_bucket = cand.shape
    a = np.zeros((b_sz, n_bucket, t_bucket), np.float32)
    b = np.zeros((b_sz, n_bucket, t_bucket), np.float32)
    for i, t in enumerate(n_tokens):
        real = (cand[i] >= 0)[:, None] & (np.arange(t_bucket) < t)[None, :]
        a[i] = np.where(real, np.float32(support[0]), 0.0)
        b[i] = np.where(real, np.float32(support[1]), 0.0)
    return a, b
