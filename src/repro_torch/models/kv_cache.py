"""KV caches for decode: full-length and ring-buffer (sliding-window).

The counterpart of ``src/repro/models/kv_cache.py``. A cache stack holds
(k, v, pos) for a group of layers with identical shape:
  k, v: (n_layers_in_stack, B, S_cache, H_kv, D_head)
  pos:  (B, S_cache) int32, the absolute position in each slot (-1 empty)

Sliding-window layers use S_cache = window with ring addressing slot =
position % window; full-attention layers use S_cache = max_seq. Positions
are stored explicitly, so prefill layouts, ring wrap-around and validity
all fall out of one mask: valid = pos >= 0 (and the window / causal mask
handles recency).

JAX updates the cache functionally; ``write_token`` here writes the slot in
place (``index_copy_``), PyTorch's idiom, and returns the same tensors with
the values JAX's update returns.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple, Union

import torch


class CacheStack(NamedTuple):
    k: torch.Tensor     # (n, B, S_cache, Hkv, Dh)
    v: torch.Tensor
    pos: torch.Tensor   # (B, S_cache) int32, shared across the stack's layers


Cache = Dict[str, CacheStack]
Position = Union[int, torch.Tensor]


def init_stack(n_layers: int, batch: int, s_cache: int, n_kv_heads: int,
               d_head: int, dtype=torch.bfloat16,
               device="cuda") -> CacheStack:
    shape = (n_layers, batch, s_cache, n_kv_heads, d_head)
    return CacheStack(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((batch, s_cache), -1, dtype=torch.int32,
                       device=device),
    )


def decode_slot(position: Position, s_cache: int) -> Position:
    """Ring slot for an absolute position (identity when the cache is
    full-length)."""
    return position % s_cache


def write_token(stack_k: torch.Tensor, stack_v: torch.Tensor,
                pos_arr: torch.Tensor, k_new: torch.Tensor,
                v_new: torch.Tensor, position: Position
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Write one decode token into a single layer's (B, S, H, D) cache
    slices, in place. k_new / v_new: (B, 1, H, D); position: an int or a
    0-d int tensor (the same for the batch)."""
    B, s_cache = stack_k.shape[:2]
    pos = position_tensor(position, stack_k.device)
    slot = decode_slot(pos, s_cache).reshape(1)
    stack_k.index_copy_(1, slot, k_new.to(stack_k.dtype))
    stack_v.index_copy_(1, slot, v_new.to(stack_v.dtype))
    pos_arr.index_copy_(1, slot, pos.to(torch.int32).reshape(1, 1)
                        .expand(B, 1).contiguous())
    return stack_k, stack_v, pos_arr


def position_tensor(position: Position, device) -> torch.Tensor:
    """``position`` as a 0-d int64 tensor on ``device``: an int is filled
    in on the device (no host copy), a tensor moved there."""
    if isinstance(position, torch.Tensor):
        return position.to(device=device, dtype=torch.int64).reshape(())
    return torch.full((), position, dtype=torch.int64, device=device)


def prefill_write(k_seq: torch.Tensor, v_seq: torch.Tensor,
                  positions: torch.Tensor, s_cache: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Turn per-layer prefill K/V (B, S, H, D) into a cache of size s_cache.

    Full cache (s_cache >= S): pad to the right.
    Ring cache  (s_cache <  S): keep the last s_cache tokens at their ring
    slots (older tokens are outside the window by construction)."""
    B, S, H, D = k_seq.shape
    if s_cache >= S:
        pad = s_cache - S
        k = torch.nn.functional.pad(k_seq, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v_seq, (0, 0, 0, 0, 0, pad))
        pos = torch.nn.functional.pad(positions.to(torch.int32), (0, pad),
                                      value=-1)
        return k, v, pos
    k_tail = k_seq[:, S - s_cache:]
    v_tail = v_seq[:, S - s_cache:]
    p_tail = positions[:, S - s_cache:].to(torch.int32)
    slots = (p_tail[0] % s_cache).to(torch.int64)            # (s_cache,)
    k = torch.zeros((B, s_cache, H, D), dtype=k_seq.dtype,
                    device=k_seq.device)
    v = torch.zeros_like(k)
    pos = torch.full((B, s_cache), -1, dtype=torch.int32,
                     device=k_seq.device)
    k[:, slots] = k_tail
    v[:, slots] = v_tail
    pos[:, slots] = p_tail
    return k, v, pos
