"""Factorization Machine [Rendle, ICDM'10].

39 sparse fields, embed_dim=10, pairwise interactions via the O(nk)
sum-square trick.
"""
from repro_torch.configs.base import RecsysConfig, criteo_like_vocab

CONFIG = RecsysConfig(
    name="fm",
    interaction="fm-2way",
    n_sparse=39,
    embed_dim=10,
    vocab_sizes=criteo_like_vocab(39),
)
