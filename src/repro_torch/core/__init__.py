"""Col-Bandit core: bounds, LUCB selection and the pooled reveal engine."""
from repro_torch.core.batched import BatchedConfig
from repro_torch.core.frontier import (DrawSource, PooledResult, TorchDraws,
                                       run_pooled_bandit, run_pooled_oracle)
from repro_torch.core.metrics import overlap_at_k

__all__ = ["BatchedConfig", "DrawSource", "PooledResult", "TorchDraws",
           "run_pooled_bandit", "run_pooled_oracle", "overlap_at_k"]
