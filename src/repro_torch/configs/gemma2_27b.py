"""Gemma2-27B [arXiv:2408.00118; hf].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000, local+global
alternating attention (w=4096 on local layers), logit softcaps.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="gemma2-27b",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=36864,
    vocab=256000,
    sliding_window=4096,
    local_global_alternating=True,
    attn_softcap=50.0,
    logit_softcap=30.0,
    act="gelu",
)
