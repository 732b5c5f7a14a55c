"""Retrieval and Col-Bandit config dataclasses (the serving subset of
``repro.configs.base``). Field names and defaults match the JAX package, so
``BanditConfig(**dataclasses.asdict(jax_cfg))`` carries a config across."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ShapeSpec:
    """One serving input-shape cell (the retrieval fields only)."""
    name: str
    kind: str
    batch: int = 0
    n_candidates: int = 0


# Paper-native retrieval shapes: batched late-interaction reranking.
RETRIEVAL_SHAPES: Tuple[ShapeSpec, ...] = (
    # queries per step x candidate docs per query
    ShapeSpec(name="rerank_online", kind="serve", batch=256, n_candidates=256),
    ShapeSpec(name="rerank_bulk", kind="serve", batch=4096, n_candidates=512),
)


@dataclass(frozen=True)
class RetrievalConfig:
    """The paper's own workload: late-interaction reranking."""
    name: str
    query_tokens: int                    # T
    doc_tokens: int                      # L (padded)
    dim: int                             # M
    corpus_docs: int                     # corpus size (serving)
    ann_kprime: int = 10
    family: str = "retrieval"
    shapes: Tuple[ShapeSpec, ...] = RETRIEVAL_SHAPES


@dataclass(frozen=True)
class BanditConfig:
    """Col-Bandit hyper-parameters (paper Sec. 4)."""
    k: int = 5
    delta: float = 0.01
    alpha_ef: float = 0.3
    epsilon: float = 0.1
    radius_c: float = 1.0
    bias_kappa: float = 0.25  # O(1/n) EBS range term; 0 = paper's exact Eq.12
    support: Tuple[float, float] = (0.0, 1.0)
    warmup_fraction: float = 0.0     # static warm-up variant; 0 => one cell/doc
    max_reveals: int = -1            # -1 => N*T
    # block-synchronous variant
    block_docs: int = 8              # B docs refined per round
    block_tokens: int = 8            # G tokens revealed per selected doc
