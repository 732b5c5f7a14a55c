"""Serving-side fault tolerance: the deadline batcher and the chaos
harness."""
from repro_torch.dist.fault import (ChaosClock, ChaosKill, DeadlineBatcher,
                                    FaultPlan, InjectedFault, apply_delay,
                                    poison_corpus)

__all__ = ["ChaosClock", "ChaosKill", "DeadlineBatcher", "FaultPlan",
           "InjectedFault", "apply_delay", "poison_corpus"]
