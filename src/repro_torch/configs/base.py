"""Retrieval, Col-Bandit, LM, GNN and recsys config dataclasses (the port
of ``repro.configs.base``). Field names and defaults match the JAX
package, so ``BanditConfig(**dataclasses.asdict(jax_cfg))``,
``LMConfig(**...)``, ``GNNConfig(**...)`` and ``RecsysConfig(**...)``
carry a config across."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell.

    kind: "train" (a train step), "prefill", "decode" (one new token
    against a KV cache) or "serve" (a forward scoring step)."""
    name: str
    kind: str
    # LM shapes
    seq_len: int = 0
    global_batch: int = 0
    # GNN shapes
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    graph_batch: int = 0
    # RecSys / retrieval shapes
    batch: int = 0
    n_candidates: int = 0

    def __post_init__(self):
        object.__setattr__(self, "fanout", tuple(self.fanout))


def _shape(spec) -> ShapeSpec:
    """A ``ShapeSpec``, or one from ``dataclasses.asdict`` of the JAX
    package's."""
    if isinstance(spec, ShapeSpec):
        return spec
    return ShapeSpec(**spec)


LM_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec(name="train_4k", kind="train", seq_len=4096, global_batch=256),
    ShapeSpec(name="prefill_32k", kind="prefill", seq_len=32768,
              global_batch=32),
    ShapeSpec(name="decode_32k", kind="decode", seq_len=32768,
              global_batch=128),
    ShapeSpec(name="long_500k", kind="decode", seq_len=524288,
              global_batch=1),
)


GNN_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec(name="full_graph_sm", kind="train", n_nodes=2708,
              n_edges=10556, d_feat=1433),
    ShapeSpec(name="minibatch_lg", kind="train", n_nodes=232965,
              n_edges=114615892, batch_nodes=1024, fanout=(15, 10),
              d_feat=602),
    ShapeSpec(name="ogb_products", kind="train", n_nodes=2449029,
              n_edges=61859140, d_feat=100),
    ShapeSpec(name="molecule", kind="train", n_nodes=30, n_edges=64,
              graph_batch=128, d_feat=16),
)


RECSYS_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec(name="train_batch", kind="train", batch=65536),
    ShapeSpec(name="serve_p99", kind="serve", batch=512),
    ShapeSpec(name="serve_bulk", kind="serve", batch=262144),
    ShapeSpec(name="retrieval_cand", kind="serve", batch=1,
              n_candidates=1_000_000),
)


# Paper-native retrieval shapes: batched late-interaction reranking.
RETRIEVAL_SHAPES: Tuple[ShapeSpec, ...] = (
    # queries per step x candidate docs per query
    ShapeSpec(name="rerank_online", kind="serve", batch=256, n_candidates=256),
    ShapeSpec(name="rerank_bulk", kind="serve", batch=4096, n_candidates=512),
)


@dataclass(frozen=True)
class RetrievalConfig:
    """The paper's own workload: late-interaction reranking."""
    name: str
    query_tokens: int                    # T
    doc_tokens: int                      # L (padded)
    dim: int                             # M
    corpus_docs: int                     # corpus size (serving)
    ann_kprime: int = 10
    family: str = "retrieval"
    shapes: Tuple[ShapeSpec, ...] = RETRIEVAL_SHAPES


@dataclass(frozen=True)
class BanditConfig:
    """Col-Bandit hyper-parameters (paper Sec. 4)."""
    k: int = 5
    delta: float = 0.01
    alpha_ef: float = 0.3
    epsilon: float = 0.1
    radius_c: float = 1.0
    bias_kappa: float = 0.25  # O(1/n) EBS range term; 0 = paper's exact Eq.12
    support: Tuple[float, float] = (0.0, 1.0)
    warmup_fraction: float = 0.0     # static warm-up variant; 0 => one cell/doc
    max_reveals: int = -1            # -1 => N*T
    # block-synchronous variant
    block_docs: int = 8              # B docs refined per round
    block_tokens: int = 8            # G tokens revealed per selected doc


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # MoE
    moe: bool = False
    n_experts: int = 0
    experts_top_k: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    # attention flavor
    sliding_window: Optional[int] = None           # SWA on every layer
    local_global_alternating: bool = False         # gemma2: even layers local
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    act: str = "silu"
    attn_q_chunk: int = 0     # >0: memory-efficient chunked attention
    family: str = "lm"
    shapes: Tuple[ShapeSpec, ...] = LM_SHAPES
    # late-interaction head (paper integration): project d_model -> li_dim
    li_dim: int = 128

    def __post_init__(self):
        # asdict() of a JAX config turns its shapes into dicts.
        object.__setattr__(self, "shapes",
                           tuple(_shape(s) for s in self.shapes))

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, ff = self.d_model, self.d_ff
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            attn += self.q_dim + 2 * self.kv_dim
        if self.moe:
            e_ff = self.moe_d_ff or ff
            mlp = self.n_experts * 3 * d * e_ff + d * self.n_experts
        else:
            mlp = 3 * d * ff
        norms = 2 * d
        block = attn + mlp + norms
        emb = self.vocab * d
        head = self.vocab * d
        return emb + self.n_layers * block + norms + head

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.moe:
            return self.param_count()
        d, e_ff = self.d_model, (self.moe_d_ff or self.d_ff)
        full = self.param_count()
        all_experts = self.n_experts * 3 * d * e_ff
        active = self.experts_top_k * 3 * d * e_ff
        return full - self.n_layers * (all_experts - active)


@dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int
    d_hidden: int
    aggregators: Tuple[str, ...] = ("mean", "max", "min", "std")
    scalers: Tuple[str, ...] = ("identity", "amplification", "attenuation")
    n_classes: int = 47
    towers: int = 1
    family: str = "gnn"
    shapes: Tuple[ShapeSpec, ...] = GNN_SHAPES

    def __post_init__(self):
        object.__setattr__(self, "shapes",
                           tuple(_shape(s) for s in self.shapes))
        for name in ("aggregators", "scalers"):
            object.__setattr__(self, name, tuple(getattr(self, name)))


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    # "fm-2way" | "self-attn" | "self-attn-seq" | "target-attn"
    interaction: str
    embed_dim: int
    n_sparse: int = 0
    vocab_sizes: Tuple[int, ...] = ()    # per-field table rows
    # AutoInt
    n_attn_layers: int = 0
    n_heads: int = 0
    d_attn: int = 0
    # SASRec
    n_blocks: int = 0
    seq_len: int = 0
    item_vocab: int = 0
    # DIN
    attn_mlp: Tuple[int, ...] = ()
    mlp: Tuple[int, ...] = ()
    family: str = "recsys"
    shapes: Tuple[ShapeSpec, ...] = RECSYS_SHAPES

    def __post_init__(self):
        object.__setattr__(self, "shapes",
                           tuple(_shape(s) for s in self.shapes))
        for name in ("vocab_sizes", "attn_mlp", "mlp"):
            object.__setattr__(self, name, tuple(getattr(self, name)))


def criteo_like_vocab(n_fields: int, seed: int = 0) -> Tuple[int, ...]:
    """Deterministic, criteo-shaped table sizes: a few huge, many small."""
    sizes = []
    for i in range(n_fields):
        if i % 13 == 0:
            sizes.append(10_000_000)
        elif i % 5 == 0:
            sizes.append(1_000_000)
        elif i % 3 == 0:
            sizes.append(100_000)
        else:
            sizes.append(10_000 + 997 * i)
    return tuple(sizes)
