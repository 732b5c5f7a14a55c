"""Serving runtime pieces: shape buckets and the fidelity ladder."""
from repro_torch.serve.bucketing import (ShapeBuckets, pad_candidates,
                                         pad_queries, support_bounds)
from repro_torch.serve.resilience import DegradeLadder

__all__ = ["DegradeLadder", "ShapeBuckets", "pad_candidates", "pad_queries",
           "support_bounds"]
