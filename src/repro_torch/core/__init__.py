"""Col-Bandit core: bounds, draws, the sequential, block and pooled
bandits, the generalized bandit over any sum-decomposable score,
baselines and metrics."""
from repro_torch.core.bandit import BanditResult, run_bandit
from repro_torch.core.batched import (BatchedConfig, run_batched_bandit,
                                      run_batched_oracle)
from repro_torch.core.draws import DrawSource, TorchDraws
from repro_torch.core.frontier import (FrontierState, PooledResult,
                                       init_frontier_state,
                                       run_pooled_bandit, run_pooled_oracle,
                                       run_pooled_slice)
from repro_torch.core.generalized import (component_support,
                                         dot_components, fm_pair_components,
                                         topk_bandit_generalized)
from repro_torch.core.metrics import overlap_at_k

__all__ = ["BanditResult", "BatchedConfig", "DrawSource", "FrontierState",
           "PooledResult", "TorchDraws", "component_support",
           "dot_components", "fm_pair_components", "init_frontier_state",
           "overlap_at_k", "run_bandit", "run_batched_bandit",
           "run_batched_oracle", "run_pooled_bandit", "run_pooled_oracle",
           "run_pooled_slice", "topk_bandit_generalized"]
