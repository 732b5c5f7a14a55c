"""The distributed-execution layer of the port (``repro.dist``'s
counterpart). Module map:

  mesh          the single-process device ``Mesh`` (a device list, one per
                shard; shards on one card are views of one tensor), value
                placement (``place``, ``Sharded``; by a per-dim spec
                ``place_blocks`` / ``full_blocks``, ``Blocks``: the KV
                cache's per-device blocks) and the corpus table.
  sharding      the placement rule engine: per-dim specs and the LM /
                optimizer / batch / KV-cache, GNN and recsys rules for the
                production meshes; the corpus rules re-exported from mesh.
  collectives   ring all-gather and ring matmul over a mesh, one explicit
                copy a hop.
  flash_decode  split-K decode attention over the sequence-sharded KV
                cache (placed in per-device blocks, or one tensor), bound
                with ``configure()``.
  act_sharding  JAX's activation-constraint fit as a pure function,
                ``fitted_spec`` (eager PyTorch has no partitioner to
                hint, so there is no ``constrain``).
  fault         the training failure guard, the deadline batcher, the
                chaos harness and ``reshard``.
"""
from repro_torch.dist.collectives import ring_all_gather, ring_matmul
from repro_torch.dist.fault import (ChaosClock, ChaosKill, DeadlineBatcher,
                                    FaultPlan, InjectedFault,
                                    SimulatedFailure, apply_delay,
                                    poison_corpus, reshard,
                                    simulate_failure)
from repro_torch.dist.flash_decode import flash_decode_attention
from repro_torch.dist.mesh import (Blocks, Mesh, Sharded, corpus_axes,
                                   corpus_specs, full_blocks, make_host_mesh,
                                   make_mesh, mesh_devices, place,
                                   place_blocks)
from repro_torch.dist.sharding import (ShardingRules, Spec, fsdp_axes,
                                       gnn_param_rules, lm_batch_spec,
                                       lm_cache_specs, lm_opt_rules,
                                       lm_param_rules, recsys_param_rules,
                                       shard_shape, specs_from_rules,
                                       tp_axis)

__all__ = ["ChaosClock", "ChaosKill", "DeadlineBatcher", "FaultPlan",
           "InjectedFault", "SimulatedFailure", "simulate_failure",
           "apply_delay", "poison_corpus", "reshard",
           "Blocks", "Mesh", "Sharded", "corpus_axes", "corpus_specs",
           "full_blocks", "make_host_mesh", "make_mesh", "mesh_devices",
           "place", "place_blocks",
           "ring_all_gather", "ring_matmul", "flash_decode_attention",
           "ShardingRules", "Spec", "fsdp_axes", "gnn_param_rules",
           "lm_batch_spec", "lm_cache_specs", "lm_opt_rules",
           "lm_param_rules", "recsys_param_rules", "shard_shape",
           "specs_from_rules", "tp_axis"]
