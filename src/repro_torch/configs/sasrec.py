"""SASRec [arXiv:1808.09781].

embed_dim=50, 2 self-attention blocks, 1 head, history seq_len=50.
"""
from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    name="sasrec",
    interaction="self-attn-seq",
    embed_dim=50,
    n_blocks=2,
    n_heads=1,
    seq_len=50,
    item_vocab=1_000_000,
)
