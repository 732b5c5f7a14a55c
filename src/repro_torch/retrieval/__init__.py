"""Late-interaction retrieval: index, stage-1 kNN, rerank steps, pipeline."""
from repro_torch.retrieval.ann import CandidateSet, generate_candidates
from repro_torch.retrieval.index import (TokenIndex, build_index, from_arrays,
                                         from_numpy)
from repro_torch.retrieval.pipeline import ServeResult, serve_queries

__all__ = ["CandidateSet", "generate_candidates", "TokenIndex", "build_index",
           "from_arrays", "from_numpy", "ServeResult", "serve_queries"]
