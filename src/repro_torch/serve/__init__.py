"""Serving runtime: the retrieval engines (``RetrievalEngine`` and the
threaded ``AsyncRetrievalEngine``), shape buckets, and the self-healing
layer (``Supervisor``, ``DegradeLadder``, the chaos harness re-exported
from ``repro_torch.dist.fault``)."""
from repro_torch.serve.bucketing import (ShapeBuckets, pad_candidates,
                                         pad_queries, support_bounds)
from repro_torch.serve.engine import (AdmissionRejected,
                                      AsyncRetrievalEngine, BatchRecord,
                                      Completion, EngineConfig,
                                      EngineMetrics, Request,
                                      RetrievalEngine)
from repro_torch.serve.resilience import (ChaosClock, ChaosKill,
                                          DegradeLadder, FaultPlan,
                                          InjectedFault, Supervisor,
                                          poison_corpus)

__all__ = [
    "ShapeBuckets", "pad_candidates", "pad_queries", "support_bounds",
    "AdmissionRejected", "AsyncRetrievalEngine", "BatchRecord", "Completion",
    "EngineConfig", "EngineMetrics", "Request", "RetrievalEngine",
    "ChaosClock", "ChaosKill", "DegradeLadder", "FaultPlan", "InjectedFault",
    "Supervisor", "poison_corpus",
]
