"""Inputs of one run, and the program under test set up to serve them.

The corpus, the query pool and each pool query's candidate list are made
from the configuration's ``data_seed``: one index, as a deployment serves
one, so that every seed asks the same work of the program (with the
corpus drawn from the run's seed, the seed moved qps by about 7 %). The
run's seed draws the order in which the pool is sent (request ``i``
carries pool query ``order[i % P]``) and the bandit's draws (the engine's
``seed``). The program is ``repro_torch``'s ``AsyncRetrievalEngine``; the
benchmark hands it the corpus it made and submits requests through
``submit`` / ``future``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from perfbench.data import corpus as data
from perfbench.harness.client import Record
from perfbench.harness.trace import HostSpans


@dataclasses.dataclass
class Inputs:
    corpus: data.Corpus
    pool: data.QueryPool
    cands: Optional[torch.Tensor]       # (P, n) or None (stage-1 requests)
    order: np.ndarray                   # pool index of request i % P
    queries_host: np.ndarray            # (P, T, M) f32
    cands_host: Optional[np.ndarray]    # (P, n) i32

    def pool_index(self, i: int) -> int:
        return int(self.order[i % len(self.order)])


def make_inputs(config: dict, mix: dict, seed: int, device) -> Inputs:
    g = data.generator(config["data_seed"], device)
    corpus = data.make_corpus(config, g, device)
    pool = data.make_queries(config, corpus, int(mix["query_pool"]), g)
    n = int(mix.get("candidates", 0))
    cands = data.make_candidates(corpus, pool, n, g) if n else None
    order = torch.randperm(pool.queries.shape[0],
                           generator=data.generator(seed, device),
                           device=device).cpu().numpy()
    return Inputs(corpus, pool, cands, order,
                  pool.queries.cpu().numpy(),
                  None if cands is None else
                  cands.cpu().numpy().astype(np.int32))


def engine_config(workload: dict, seed: int):
    """The cell's ``EngineConfig``; its draw seed is the run's."""
    from repro_torch.serve import EngineConfig
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in workload["engine"].items()}
    fields["seed"] = int(seed) % (1 << 31)
    return EngineConfig(**fields)


class Served:
    """The engine over one run's inputs, its buckets warmed, with host spans
    around its stage-1, step and harvest calls."""

    def __init__(self, inputs: Inputs, workload: dict, mix: dict, seed: int,
                 device, clock: Callable[[], float] = time.perf_counter):
        from repro_torch.serve import AsyncRetrievalEngine, Request
        self._Request = Request
        self.inputs = inputs
        self.clock = clock
        self.k = int(mix["k"])
        cfg = engine_config(workload, seed)
        self.engine = AsyncRetrievalEngine(inputs.corpus.embs,
                                           inputs.corpus.mask, cfg,
                                           device=device)
        self.spans = HostSpans()
        self.spans.wrap(self.engine, "_stage1", "stage1", count_arg=1)
        self.spans.wrap(self.engine, "_dispatch_batch", "step",
                        rids=lambda prep: [q.rid for q in prep.real])
        self.spans.wrap(self.engine, "_finish_batch", "harvest")

    def buckets(self) -> List[tuple]:
        """The warmed-step keys this cell's traffic reaches, and no others."""
        eng, inp = self.engine, self.inputs
        tb = eng.buckets.token_bucket(inp.queries_host.shape[1])
        if inp.cands_host is None:
            nb = eng.buckets.cand_bucket(eng._stage1_n)
            return [("stage1", tb), ("step", eng.flavor_for(nb), tb, nb)]
        nb = eng.buckets.cand_bucket(inp.cands_host.shape[1])
        return [("step", eng.flavor_for(nb), tb, nb)]

    def warm(self, n_requests: int) -> None:
        """Build and run the cell's buckets, start the engine and serve
        ``n_requests`` of the stream's requests (not counted)."""
        for key in self.buckets():
            self.engine._executable(key)
        self.engine._warmed = True
        self.engine.start()
        futs = [self.engine.future(self.engine.submit(self.request(i)))
                for i in range(n_requests)]
        for f in futs:
            if f.result(timeout=600).error is not None:
                raise RuntimeError("a warm-up request failed")

    def request(self, i: int):
        p = self.inputs.pool_index(i)
        cand = (None if self.inputs.cands_host is None
                else self.inputs.cands_host[p])
        return self._Request(query=self.inputs.queries_host[p], k=self.k,
                             cand_ids=cand)

    def send(self, rec: Record):
        """Submit request ``rec.i``; its answer lands in ``rec``."""
        clock = self.clock
        rec.sent = clock()
        try:
            fut = self.engine.future(self.engine.submit(self.request(rec.i)))
        except Exception as e:          # refused at submit: a failed request
            rec.error, rec.done = repr(e), clock()
            return None

        def landed(f, rec=rec):
            rec.done = clock()
            c = f.result()
            rec.completion = c
            if c.error is not None:
                rec.error = c.error

        fut.add_done_callback(landed)
        return fut

    def stop(self) -> None:
        self.engine.stop()
