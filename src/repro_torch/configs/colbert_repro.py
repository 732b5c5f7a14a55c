"""The paper's own workloads (Sec. 5 / App. A.2).

Text: ColBERTv2 / Jina-ColBERT-v2 — d=128, fixed T=32 query tokens.
Multimodal: Granite Vision Embedding — d=128, 729 doc tokens per image.
"""
from repro_torch.configs.base import RetrievalConfig

TEXT_CONFIG = RetrievalConfig(
    name="colbert-text",
    query_tokens=32,
    doc_tokens=128,
    dim=128,
    corpus_docs=5_230_000,   # HotPotQA-scale
    ann_kprime=10,
)

MM_CONFIG = RetrievalConfig(
    name="colbert-mm",
    query_tokens=64,
    doc_tokens=729,
    dim=128,
    corpus_docs=2_600_000,
    ann_kprime=10,
)
