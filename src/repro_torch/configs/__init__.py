"""Config registry: ``get_config(<arch id>)`` -> config object, for what
the port runs: the paper's retrieval configs and the dense LM backbones
(the JAX package's ``repro.configs`` registry, without the MoE, GNN and
recsys configs, which come with their models)."""
from repro_torch.configs.base import (LM_SHAPES, BanditConfig, LMConfig,
                                      RetrievalConfig, ShapeSpec)
from repro_torch.configs.colbert_repro import MM_CONFIG, TEXT_CONFIG
from repro_torch.configs.gemma2_27b import CONFIG as GEMMA2_27B
from repro_torch.configs.internlm2_20b import CONFIG as INTERNLM2_20B
from repro_torch.configs.qwen2_5_3b import CONFIG as QWEN2_5_3B

REGISTRY = {
    "internlm2-20b": INTERNLM2_20B,
    "gemma2-27b": GEMMA2_27B,
    "qwen2.5-3b": QWEN2_5_3B,
    # the paper's own workload
    "colbert-text": TEXT_CONFIG,
    "colbert-mm": MM_CONFIG,
}


def get_config(arch: str):
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch]


__all__ = ["BanditConfig", "RetrievalConfig", "ShapeSpec", "TEXT_CONFIG",
           "MM_CONFIG", "LMConfig", "LM_SHAPES", "QWEN2_5_3B",
           "INTERNLM2_20B", "GEMMA2_27B", "REGISTRY", "get_config"]
