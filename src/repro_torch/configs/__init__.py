from repro_torch.configs.base import BanditConfig, RetrievalConfig, ShapeSpec
from repro_torch.configs.colbert_repro import MM_CONFIG, TEXT_CONFIG

__all__ = ["BanditConfig", "RetrievalConfig", "ShapeSpec", "TEXT_CONFIG",
           "MM_CONFIG"]
