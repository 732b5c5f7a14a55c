"""Mixtral 8x22B [arXiv:2401.04088; hf].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8 experts top-2,
sliding-window attention (w=4096).
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="mixtral-8x22b",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab=32768,
    moe=True,
    n_experts=8,
    experts_top_k=2,
    moe_d_ff=16384,
    sliding_window=4096,
    rope_theta=1_000_000.0,
)
