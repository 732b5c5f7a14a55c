"""Moonshot/Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (GQA kv=16) expert d_ff=1408 vocab=163840, MoE 64e top-6.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab=163840,
    moe=True,
    n_experts=64,
    experts_top_k=6,
    moe_d_ff=1408,
    rope_theta=50_000.0,
)
