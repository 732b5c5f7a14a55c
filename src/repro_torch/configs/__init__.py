"""Config registry: ``get_config(<arch id>)`` -> config object: the
paper's retrieval configs, the LM backbones (dense and MoE), the GNN and
the recsys models (the JAX package's ``repro.configs`` registry).
``ASSIGNED_ARCHS`` is the assigned pool of ten archs and ``all_cells``
walks its (arch x shape) cells, as the launcher does."""
from repro_torch.configs.autoint import CONFIG as AUTOINT
from repro_torch.configs.base import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES,
                                      RETRIEVAL_SHAPES, BanditConfig, GNNConfig, LMConfig,
                                      RecsysConfig, RetrievalConfig,
                                      ShapeSpec, criteo_like_vocab)
from repro_torch.configs.colbert_repro import MM_CONFIG, TEXT_CONFIG
from repro_torch.configs.din import CONFIG as DIN
from repro_torch.configs.fm import CONFIG as FM
from repro_torch.configs.gemma2_27b import CONFIG as GEMMA2_27B
from repro_torch.configs.internlm2_20b import CONFIG as INTERNLM2_20B
from repro_torch.configs.mixtral_8x22b import CONFIG as MIXTRAL_8X22B
from repro_torch.configs.moonshot_v1_16b_a3b import \
    CONFIG as MOONSHOT_V1_16B_A3B
from repro_torch.configs.pna import CONFIG as PNA
from repro_torch.configs.qwen2_5_3b import CONFIG as QWEN2_5_3B
from repro_torch.configs.sasrec import CONFIG as SASREC

REGISTRY = {
    "mixtral-8x22b": MIXTRAL_8X22B,
    "moonshot-v1-16b-a3b": MOONSHOT_V1_16B_A3B,
    "internlm2-20b": INTERNLM2_20B,
    "gemma2-27b": GEMMA2_27B,
    "qwen2.5-3b": QWEN2_5_3B,
    "pna": PNA,
    "autoint": AUTOINT,
    "sasrec": SASREC,
    "din": DIN,
    "fm": FM,
    # the paper's own workload
    "colbert-text": TEXT_CONFIG,
    "colbert-mm": MM_CONFIG,
}


ASSIGNED_ARCHS = [
    "mixtral-8x22b", "moonshot-v1-16b-a3b", "internlm2-20b", "gemma2-27b",
    "qwen2.5-3b", "pna", "autoint", "sasrec", "din", "fm",
]


def get_config(arch: str):
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch]


def all_cells(archs=None):
    """Enumerate every (arch, config, shape) cell of ``archs`` (default:
    the assigned pool)."""
    archs = archs or ASSIGNED_ARCHS
    for arch in archs:
        cfg = get_config(arch)
        for shape in cfg.shapes:
            yield arch, cfg, shape


__all__ = ["BanditConfig", "RetrievalConfig", "ShapeSpec", "TEXT_CONFIG",
           "MM_CONFIG", "LMConfig", "LM_SHAPES", "QWEN2_5_3B",
           "INTERNLM2_20B", "GEMMA2_27B", "MIXTRAL_8X22B",
           "MOONSHOT_V1_16B_A3B", "GNNConfig", "GNN_SHAPES", "PNA",
           "RecsysConfig", "RECSYS_SHAPES", "RETRIEVAL_SHAPES",
           "criteo_like_vocab", "FM", "AUTOINT", "DIN", "SASREC",
           "REGISTRY", "ASSIGNED_ARCHS", "get_config", "all_cells"]
