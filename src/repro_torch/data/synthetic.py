"""Synthetic late-interaction corpora with controllable relevance structure.

BEIR/REAL-MM-RAG cannot ship in this container, so experiments run on a
topic-model generator that preserves the statistics that matter for
Col-Bandit: (i) normalized token embeddings (cosine MaxSim in [-1, 1], and
in ~[0, 1] for matching topics), (ii) a small set of truly relevant
documents per query whose MaxSim rows dominate, (iii) a long tail of
near-miss distractors that cluster near the decision boundary (these are
what make adaptive allocation pay off), and (iv) variable document lengths.

Every generator is seeded and returns plain numpy (converted lazily to jnp
by consumers) so the data pipeline stays deterministic across restarts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class RetrievalDataset:
    doc_embs: np.ndarray       # (C, L, M) float32, L2-normalized tokens
    doc_mask: np.ndarray       # (C, L) bool
    doc_lens: np.ndarray       # (C,) int32
    queries: np.ndarray        # (Q, T, M) float32
    qrels: np.ndarray          # (Q, C) bool — relevance labels
    topics: np.ndarray         # (K_topics, M)

    @property
    def n_docs(self) -> int:
        return self.doc_embs.shape[0]

    @property
    def n_queries(self) -> int:
        return self.queries.shape[0]


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def make_retrieval_dataset(
    *,
    n_docs: int = 512,
    n_queries: int = 16,
    n_topics: int = 32,
    doc_len: int = 96,
    min_doc_len: int = 24,
    query_len: int = 32,
    dim: int = 128,
    relevant_per_query: int = 4,
    distractors_per_query: int = 24,
    topic_strength: float = 0.7,
    distractor_strength: float = 0.55,
    seed: int = 0,
) -> RetrievalDataset:
    """Topic-model corpus.

    Each doc draws a primary topic; its tokens mix the topic direction with
    noise. A query targets one topic; `relevant_per_query` docs share it
    strongly, `distractors_per_query` share it weakly (borderline scores).
    """
    rng = np.random.default_rng(seed)
    topics = _normalize(rng.standard_normal((n_topics, dim)).astype(np.float32))

    doc_topic = rng.integers(0, n_topics, size=n_docs)
    doc_lens = rng.integers(min_doc_len, doc_len + 1, size=n_docs).astype(np.int32)
    noise = rng.standard_normal((n_docs, doc_len, dim)).astype(np.float32)
    mix = rng.uniform(0.1, 0.5, size=(n_docs, doc_len, 1)).astype(np.float32)
    doc_embs = _normalize(mix * topics[doc_topic][:, None, :] + (1 - mix) * noise * 0.4)
    doc_mask = np.arange(doc_len)[None, :] < doc_lens[:, None]
    doc_embs = np.where(doc_mask[:, :, None], doc_embs, 0.0).astype(np.float32)

    queries = np.zeros((n_queries, query_len, dim), np.float32)
    qrels = np.zeros((n_queries, n_docs), bool)
    for q in range(n_queries):
        topic = rng.integers(0, n_topics)
        qn = rng.standard_normal((query_len, dim)).astype(np.float32)
        # Real queries mix on-topic terms with generic/function tokens, so
        # per-row MaxSim values VARY — the within-row variance that the
        # empirical-Bernstein radius feeds on. ~25% of tokens are pure noise
        # ("stopwords"), the rest span weak-to-strong topicality.
        qmix = rng.uniform(0.15, 0.95, size=(query_len, 1)).astype(np.float32)
        noise_tok = rng.random(query_len) < 0.25
        qmix[noise_tok] = 0.0
        queries[q] = _normalize(qmix * topics[topic][None, :] + (1 - qmix) * qn * 0.4)

        # plant relevant docs: strengthen topic alignment of a random subset
        rel = rng.choice(n_docs, size=relevant_per_query, replace=False)
        for d in rel:
            ln = doc_lens[d]
            n_strong = max(2, int(topic_strength * min(ln, 16)))
            pos = rng.choice(ln, size=n_strong, replace=False)
            tn = rng.standard_normal((n_strong, dim)).astype(np.float32)
            doc_embs[d, pos] = _normalize(
                topic_strength * topics[topic][None, :] + (1 - topic_strength) * tn * 0.3)
        qrels[q, rel] = True

        # borderline distractors: weakly aligned, crowd the boundary
        pool = np.setdiff1d(np.arange(n_docs), rel)
        dis = rng.choice(pool, size=min(distractors_per_query, pool.size),
                         replace=False)
        for d in dis:
            ln = doc_lens[d]
            n_weak = max(1, int(0.3 * min(ln, 12)))
            pos = rng.choice(ln, size=n_weak, replace=False)
            tn = rng.standard_normal((n_weak, dim)).astype(np.float32)
            doc_embs[d, pos] = _normalize(
                distractor_strength * topics[topic][None, :]
                + (1 - distractor_strength) * tn * 0.4)

    doc_embs = np.where(doc_mask[:, :, None], doc_embs, 0.0).astype(np.float32)
    return RetrievalDataset(doc_embs=doc_embs, doc_mask=doc_mask,
                            doc_lens=doc_lens, queries=queries, qrels=qrels,
                            topics=topics)


def make_mixed_difficulty_h(n_queries: int, n_docs: int, n_tokens: int, *,
                            k: int = 10, hard_frac: float = 0.25,
                            seed: int = 0) -> np.ndarray:
    """Oracle MaxSim tensor H (Q, N, T) with a controlled difficulty mix.

    Most queries have their top-k separated by a wide margin at rank k
    (the bandit separates them in few rounds); the last ``hard_frac`` of
    queries have ~2k near-tied contenders straddling rank k (many rounds).
    This is the straggler mix that makes lockstep reveal waste visible —
    shared by the frontier-retirement tests and the reveal benchmark so
    the workload they pin is one and the same.
    """
    rng = np.random.default_rng(seed)
    H = rng.uniform(0.1, 0.4,
                    (n_queries, n_docs, n_tokens)).astype(np.float32)
    n_hard = int(round(hard_frac * n_queries))   # 0.0 -> all-easy batch
    for q in range(n_queries):
        if q < n_queries - n_hard:               # easy: clear top-k margin
            H[q, rng.choice(n_docs, k, replace=False)] += 0.5
        else:                                    # hard: 2k near-ties
            H[q, rng.choice(n_docs, 2 * k, replace=False)] += 0.3
    return np.clip(H, 0.0, 1.0)
