"""LM serving: prefill + greedy decode loop over the KV cache.

The counterpart of ``src/repro/serve/lm.py``. ``generate`` keeps JAX's
token bookkeeping: the prefill's argmax is the first new token, then
``max_new_tokens`` decode steps run (the last one's argmax is dropped, as
JAX's scan drops its final carry), and the cache is float32 unless the
caller asks for another type. It runs where the model's parameters live,
on a dense or a MoE ``DecoderLM`` alike (decode never drops a token).

With ``mesh=`` the cache is placed on that mesh (one block per shard, on
the shard's device; ``models/kv_cache.py``), which is the mesh a caller
binds split-K decode to (``dist.flash_decode.configure``); unbound, each
decode step gathers the blocks to the parameters' device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.dist.mesh import Mesh
from repro_torch.models.kv_cache import Cache, Position
from repro_torch.models.transformer import (DecoderLM, forward_decode,
                                            forward_prefill)


@torch.no_grad()
def generate(params: DecoderLM, cfg: LMConfig, prompt, *,
             max_new_tokens: int = 16, max_seq: int = 0,
             cache_dtype=torch.float32,
             mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Greedy generation. prompt (B, S) -> (B, S + max_new_tokens); with
    ``mesh`` over a cache placed on it."""
    prompt = torch.as_tensor(prompt, device=params.device)
    B, S = prompt.shape
    max_seq = max_seq or (S + max_new_tokens)
    last_logits, cache = forward_prefill(params, cfg, prompt, max_seq,
                                         cache_dtype=cache_dtype, mesh=mesh)
    tok = torch.argmax(last_logits, dim=-1).to(torch.int32)
    toks = []
    for step in range(max_new_tokens):
        logits, cache = forward_decode(params, cfg, tok, S + step, cache)
        toks.append(tok)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if not toks:
        return prompt
    return torch.cat([prompt, torch.stack(toks, dim=1).to(prompt.dtype)],
                     dim=1)


@torch.no_grad()
def serve_step(params: DecoderLM, cfg: LMConfig, token, position: Position,
               cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """One decode step: (logits (B, V), the cache updated in place). The
    cache may be placed on the mesh split-K is bound to."""
    return forward_decode(params, cfg, token, position, cache)
