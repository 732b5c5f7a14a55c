"""AutoInt [arXiv:1810.11921].

39 sparse fields, embed_dim=16, 3 self-attention interaction layers,
2 heads, d_attn=32.
"""
from repro_torch.configs.base import RecsysConfig, criteo_like_vocab

CONFIG = RecsysConfig(
    name="autoint",
    interaction="self-attn",
    n_sparse=39,
    embed_dim=16,
    vocab_sizes=criteo_like_vocab(39),
    n_attn_layers=3,
    n_heads=2,
    d_attn=32,
)
