"""Serving runtime: the retrieval engines (``RetrievalEngine`` and the
threaded ``AsyncRetrievalEngine``), shape buckets, the self-healing
layer (``Supervisor``, ``DegradeLadder``, the chaos harness re-exported
from ``repro_torch.dist.fault``), and the LM prefill/decode engine
(``generate``, ``serve_step`` from ``repro_torch.serve.lm``)."""
from repro_torch.serve.bucketing import (ShapeBuckets, pad_candidates,
                                         pad_queries, support_bounds)
from repro_torch.serve.engine import (AdmissionRejected,
                                      AsyncRetrievalEngine, BatchRecord,
                                      Completion, EngineConfig,
                                      EngineMetrics, Request,
                                      RetrievalEngine)
from repro_torch.serve.lm import generate, serve_step
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
    "generate", "serve_step",
]
