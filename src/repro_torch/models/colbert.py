"""Late-interaction (ColBERT-style) encoder head over an LM backbone.

The counterpart of ``src/repro/models/colbert.py``, the paper-integration
point: an LM backbone (dense or MoE), a linear projection to li_dim (=
128, as ColBERTv2 / Jina-ColBERT-v2 / Granite Vision) and L2 normalization
produce the token embeddings that the Col-Bandit reranker consumes. As in
JAX, padded tokens are not masked out of attention, and a MoE backbone
routes them and counts them against capacity; only their output rows are
zeroed.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import LMConfig
from repro_torch.models.layers import _param, fill_dense
from repro_torch.models.transformer import DecoderLM, forward_hidden


class LIHead(nn.Module):
    """proj (d_model, li_dim)."""

    def __init__(self, cfg: LMConfig, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.proj = _param(torch.empty((cfg.d_model, cfg.li_dim),
                                       dtype=dtype, device=device))


def init_li_head(cfg: LMConfig, *, seed: int = 0, dtype=torch.float32,
                 device="cuda",
                 generator: Optional[torch.Generator] = None) -> LIHead:
    gen = generator
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(seed)
    head = LIHead(cfg, dtype, device)
    with torch.no_grad():
        fill_dense(gen, head.proj)
    return head


@torch.no_grad()
def encode_tokens(lm_params: DecoderLM, head: LIHead, cfg: LMConfig,
                  tokens, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) + validity mask -> (B, S, li_dim) L2-normalized token
    embeddings (masked positions are zeroed), and the mask; no autograd
    graph is built."""
    mask = torch.as_tensor(mask, device=lm_params.device)
    hidden = forward_hidden(lm_params, cfg, tokens)          # (B, S, D)
    emb = hidden @ head.proj                                 # (B, S, li_dim)
    norm = torch.linalg.vector_norm(emb.to(torch.float32), dim=-1,
                                    keepdim=True)
    emb = emb / torch.clamp(norm, min=1e-9).to(emb.dtype)
    return torch.where(mask[:, :, None], emb, 0.0), mask
