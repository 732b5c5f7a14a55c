"""What one run saw, as the metric readers get it."""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List, Optional, Tuple

import numpy as np

from perfbench.harness.client import Record
from perfbench.harness.spec import Cell
from perfbench.harness.trace import Trace


@dataclasses.dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    setup_s: float
    t0: float                    # window start (perf_counter)
    t_end: float                 # window end
    records: List[Record]        # requests sent in the window
    batches: list                # the engine's BatchRecords from the window on
    n_served: int                # completions the engine made from then on
    launches: Dict[str, int]     # kernel launches from then on
    trace: Optional[Trace]
    memory_peak_bytes: int
    inputs: object
    spans: list = dataclasses.field(default_factory=list)
    # perf_counter seconds the profiler was on (traced runs)
    profiled: Optional[Tuple[float, float]] = None
    check: Optional[dict] = None

    # -- client side ------------------------------------------------------
    def completed_in_window(self) -> List[Record]:
        return [r for r in self.records if r.ok and r.done <= self.t_end]

    def unprofiled(self) -> List[Record]:
        """The requests whose life did not overlap the profiler being on
        (all of them in an untraced run)."""
        if self.profiled is None:
            return list(self.records)
        on, off = self.profiled
        return [r for r in self.records
                if r.intended > off or (r.ok and r.done < on)]

    def latency_quantile_ms(self, q: float, records=None) -> Optional[float]:
        """The q-quantile (0-1) of the latency of ``records`` (default:
        every request) from the intended send time, a failed request
        counting as infinite."""
        recs = self.records if records is None else records
        lat = sorted(r.latency_s for r in recs)
        if len(lat) < 2:
            return None
        v = statistics.quantiles(lat, n=100, method="inclusive")[
            round(q * 100) - 1] if q < 1 else lat[-1]
        return v * 1e3 if math.isfinite(v) else None

    def completions(self) -> list:
        return [r.completion for r in self.records if r.ok]

    # -- the requests' work -----------------------------------------------
    def cand_tokens(self, r: Record) -> float:
        """Sum of the true lengths of request ``r``'s candidates (for
        requests without a list: the stage-1 width times the corpus's mean
        length)."""
        inp = self.inputs
        if inp.cands is None:
            n = self.cell.workload["engine"]["stage1_candidates"]
            return n * float(inp.corpus.doc_lens.float().mean())
        cache = getattr(self, "_cand_tok", None)
        if cache is None:
            cache = (inp.corpus.doc_lens[inp.cands].sum(1).cpu().numpy()
                     .astype(np.float64))
            self._cand_tok = cache
        return float(cache[inp.pool_index(r.i)])

    def n_cand(self) -> int:
        inp = self.inputs
        if inp.cands is None:
            return int(self.cell.workload["engine"]["stage1_candidates"])
        return int(inp.cands.shape[1])

    @property
    def dims(self):
        """(T, M, corpus token slots C * L)."""
        e = self.inputs.corpus.embs
        return (int(self.inputs.pool.queries.shape[1]), int(e.shape[2]),
                float(e.shape[0] * e.shape[1]))
