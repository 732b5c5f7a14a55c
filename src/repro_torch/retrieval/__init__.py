"""Late-interaction retrieval: index, stage-1 kNN, the mesh-resident
corpus, rerank steps, pipeline."""
from repro_torch.retrieval.ann import CandidateSet, generate_candidates
from repro_torch.retrieval.index import (TokenIndex, build_index,
                                         build_index_from_ragged,
                                         from_arrays, from_numpy)
from repro_torch.retrieval.pipeline import ServeResult, serve_queries
from repro_torch.retrieval.sharded import (ShardedCorpus, route_aligned,
                                           route_batch, route_candidates,
                                           shard_corpus)

__all__ = ["CandidateSet", "generate_candidates", "TokenIndex", "build_index",
           "build_index_from_ragged", "from_arrays", "from_numpy", "ServeResult", "serve_queries",
           "ShardedCorpus", "route_aligned", "route_batch",
           "route_candidates", "shard_corpus"]
