"""InternLM2-20B [arXiv:2403.17297; hf].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544, dense.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="internlm2-20b",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab=92544,
    rope_theta=1_000_000.0,
)
