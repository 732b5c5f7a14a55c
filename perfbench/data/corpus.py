"""Seeded late-interaction corpus, query pool and candidate lists, made on
the device in a few large calls.

The statistics are those of a topic-model corpus built for Col-Bandit:
unit-norm token embeddings that mix a document's topic direction with
noise, variable document lengths, queries that mix their topic with noise
(about a quarter of their tokens pure noise), a few planted relevant
documents per query whose tokens align strongly with its topic, and
borderline distractors that align weakly. Planted documents are distinct
across the whole pool, so no token is written twice and the corpus is the
same for the same seed on the same device.

Candidate lists stand for what an upstream retriever returns: the query's
relevant documents and distractors, the rest drawn from documents of its
topic, shuffled.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Corpus:
    embs: torch.Tensor        # (C, L, M) f32, unit rows, zero where masked
    mask: torch.Tensor        # (C, L) bool, a prefix of doc_lens tokens
    doc_lens: torch.Tensor    # (C,) i64
    doc_topic: torch.Tensor   # (C,) i64
    topics: torch.Tensor      # (K, M) f32


@dataclasses.dataclass
class QueryPool:
    queries: torch.Tensor     # (P, T, M) f32
    topic: torch.Tensor       # (P,) i64
    relevant: torch.Tensor    # (P, R) i64 planted relevant docs
    distractors: torch.Tensor  # (P, D) i64 planted distractors


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-9)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make_corpus(cfg: dict, g: torch.Generator, device,
                chunk_tokens: int = 1 << 21) -> Corpus:
    """The (C, L, M) corpus of configuration ``cfg`` (keys ``n_docs``,
    ``doc_tokens``, ``min_doc_tokens``, ``dim``, ``n_topics``), built
    chunk by chunk so that the corpus is the only large tensor."""
    C, L, M = cfg["n_docs"], cfg["doc_tokens"], cfg["dim"]
    K = cfg["n_topics"]
    kw = dict(generator=g, device=device)
    topics = _unit(torch.randn((K, M), **kw))
    doc_topic = torch.randint(0, K, (C,), **kw)
    doc_lens = torch.randint(cfg["min_doc_tokens"], L + 1, (C,), **kw)
    mask = torch.arange(L, device=device)[None, :] < doc_lens[:, None]
    embs = torch.empty((C, L, M), dtype=torch.float32, device=device)
    step = max(1, chunk_tokens // L)
    for c0 in range(0, C, step):
        c1 = min(C, c0 + step)
        x = torch.randn((c1 - c0, L, M), **kw).mul_(0.4)
        mix = torch.rand((c1 - c0, L, 1), **kw).mul_(0.4).add_(0.1)
        x.mul_(1 - mix).add_(mix * topics[doc_topic[c0:c1]][:, None, :])
        embs[c0:c1] = _unit(x) * mask[c0:c1, :, None]
    return Corpus(embs, mask, doc_lens, doc_topic, topics)


def _plant(corpus: Corpus, docs: torch.Tensor, topic_dir: torch.Tensor,
           n_tok: torch.Tensor, strength: float, noise: float,
           g: torch.Generator) -> None:
    """Overwrite ``n_tok[i]`` distinct valid positions of doc ``docs[i]``
    with tokens aligned to ``topic_dir[i]`` at ``strength``."""
    dev = docs.device
    L, M = corpus.embs.shape[1:]
    lens = corpus.doc_lens[docs]
    width = int(n_tok.max())
    r = torch.rand((docs.numel(), L), generator=g, device=dev)
    r.masked_fill_(torch.arange(L, device=dev)[None, :] >= lens[:, None], 2.0)
    pos = torch.argsort(r, dim=1)[:, :width]
    tn = torch.randn((docs.numel(), width, M), generator=g, device=dev)
    tok = _unit(strength * topic_dir[:, None, :] + (1 - strength) * noise * tn)
    keep = torch.arange(width, device=dev)[None, :] < n_tok[:, None]
    rows = docs[:, None].expand(-1, width)[keep]
    corpus.embs[rows, pos[keep]] = tok[keep]


def make_queries(cfg: dict, corpus: Corpus, n_queries: int,
                 g: torch.Generator) -> QueryPool:
    """``n_queries`` queries of ``cfg["query_tokens"]`` tokens, each with
    its relevant documents and distractors planted in ``corpus``."""
    dev = corpus.embs.device
    P, T, M = n_queries, cfg["query_tokens"], cfg["dim"]
    R, D = cfg["relevant_per_query"], cfg["distractors_per_query"]
    C = corpus.embs.shape[0]
    if P * (R + D) > C:
        raise ValueError(f"{P} queries plant {P * (R + D)} docs, more than "
                         f"the corpus's {C}")
    kw = dict(generator=g, device=dev)
    topic = torch.randint(0, corpus.topics.shape[0], (P,), **kw)
    qmix = torch.rand((P, T, 1), **kw).mul_(0.8).add_(0.15)
    qmix.masked_fill_(torch.rand((P, T, 1), **kw) < 0.25, 0.0)
    qn = torch.randn((P, T, M), **kw)
    queries = _unit(qmix * corpus.topics[topic][:, None, :]
                    + (1 - qmix) * qn * 0.4)
    planted = torch.randperm(C, **kw)[:P * (R + D)].view(P, R + D)
    rel, dis = planted[:, :R], planted[:, R:]
    lens_r = corpus.doc_lens[rel.reshape(-1)]
    lens_d = corpus.doc_lens[dis.reshape(-1)]
    _plant(corpus, rel.reshape(-1), corpus.topics[topic].repeat_interleave(R, 0),
           torch.clamp((cfg["topic_strength"] * torch.clamp(lens_r, max=16)
                        ).long(), min=2),
           cfg["topic_strength"], 0.3, g)
    _plant(corpus, dis.reshape(-1), corpus.topics[topic].repeat_interleave(D, 0),
           torch.clamp((0.3 * torch.clamp(lens_d, max=12)).long(), min=1),
           cfg["distractor_strength"], 0.4, g)
    return QueryPool(queries, topic, rel, dis)


def make_candidates(corpus: Corpus, pool: QueryPool, n: int,
                    g: torch.Generator, block: int = 64) -> torch.Tensor:
    """(P, n) distinct candidate doc ids per query: its relevant documents
    and distractors, then documents of its topic, in a shuffled order."""
    dev = corpus.embs.device
    C = corpus.embs.shape[0]
    planted = torch.cat([pool.relevant, pool.distractors], dim=1)
    extra = n - planted.shape[1]
    if extra < 0:
        raise ValueError(f"{n} candidates cannot hold the "
                         f"{planted.shape[1]} planted docs of a query")
    out = []
    for p0 in range(0, planted.shape[0], block):
        p1 = min(planted.shape[0], p0 + block)
        score = torch.rand((p1 - p0, C), generator=g, device=dev)
        score.masked_fill_(corpus.doc_topic[None, :]
                           != pool.topic[p0:p1, None], -1.0)
        score.scatter_(1, planted[p0:p1], -1.0)
        drawn = torch.topk(score, extra, dim=1).indices
        if (torch.gather(score, 1, drawn) < 0).any():
            raise ValueError("a topic holds too few documents for "
                             f"{n} candidates")
        out.append(torch.cat([planted[p0:p1], drawn], dim=1))
    cand = torch.cat(out)
    order = torch.argsort(torch.rand(cand.shape, generator=g, device=dev),
                          dim=1)
    return torch.gather(cand, 1, order)
