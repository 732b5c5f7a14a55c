"""Fault tolerance (the training failure guard, the deadline batcher,
the chaos harness, ``reshard``) and the single-process device mesh with
the corpus placement table."""
from repro_torch.dist.fault import (ChaosClock, ChaosKill, DeadlineBatcher,
                                    FaultPlan, InjectedFault,
                                    SimulatedFailure, apply_delay,
                                    poison_corpus, reshard,
                                    simulate_failure)
from repro_torch.dist.mesh import (Mesh, Sharded, corpus_axes, corpus_specs,
                                   make_host_mesh, make_mesh, mesh_devices,
                                   place)

__all__ = ["ChaosClock", "ChaosKill", "DeadlineBatcher", "FaultPlan",
           "InjectedFault", "SimulatedFailure", "simulate_failure",
           "apply_delay", "poison_corpus", "reshard",
           "Mesh", "Sharded", "corpus_axes", "corpus_specs",
           "make_host_mesh", "make_mesh", "mesh_devices", "place"]
