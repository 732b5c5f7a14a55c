"""Qwen2.5-3B [hf:Qwen/Qwen2.5-3B].

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936, QKV bias.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="qwen2.5-3b",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_head=128,
    d_ff=11008,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
