"""DIN -- Deep Interest Network [arXiv:1706.06978].

embed_dim=18, user-history seq_len=100, attention MLP 80-40, main MLP 200-80.
"""
from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    name="din",
    interaction="target-attn",
    embed_dim=18,
    seq_len=100,
    item_vocab=2_000_000,
    attn_mlp=(80, 40),
    mlp=(200, 80),
)
