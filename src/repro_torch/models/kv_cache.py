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

A stack placed on a mesh (``init_stack(..., mesh=...)``) holds k, v and pos
as :class:`~repro_torch.dist.mesh.Blocks` laid out by
``dist/sharding.py::lm_cache_specs``: the batch over the FSDP axes where it
divides, the slots over ``model``, one block per shard on that shard's
device (views of one copy where shards share a device). ``write_token``
then writes a token only into the blocks that own its slot (a ring slot
wraps across blocks), and :func:`prefill_write`'s global layout goes in
with ``Blocks.copy_``: each write gives what JAX's update of the global
array gives.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.dist.mesh import Blocks, Mesh, full_blocks
from repro_torch.dist.sharding import lm_cache_specs

Slab = Union[torch.Tensor, Blocks]


class CacheStack(NamedTuple):
    k: Slab     # (n, B, S_cache, Hkv, Dh)
    v: Slab
    pos: Slab   # (B, S_cache) int32, shared across the stack's layers


Cache = Dict[str, CacheStack]
Position = Union[int, torch.Tensor]


def init_stack(n_layers: int, batch: int, s_cache: int, n_kv_heads: int,
               d_head: int, dtype=torch.bfloat16, device="cuda",
               mesh: Optional[Mesh] = None) -> CacheStack:
    """An empty stack on ``device``, or with ``mesh`` placed on the mesh by
    ``lm_cache_specs`` (``device`` unused): each device's zeros made there.
    Raises ValueError where the slots or the batch do not split."""
    shape = (n_layers, batch, s_cache, n_kv_heads, d_head)
    if mesh is not None:
        spec = lm_cache_specs(mesh, batch)
        return CacheStack(
            k=full_blocks(shape, 0, dtype, mesh, spec["k"]),
            v=full_blocks(shape, 0, dtype, mesh, spec["v"]),
            pos=full_blocks((batch, s_cache), -1, torch.int32, mesh,
                            spec["pos"]))
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


def write_token(stack_k: Slab, stack_v: Slab, pos_arr: Slab,
                k_new: torch.Tensor, v_new: torch.Tensor, position: Position
                ) -> Tuple[Slab, Slab, Slab]:
    """Write one decode token into a single layer's (B, S, H, D) cache
    slices, in place. k_new / v_new: (B, 1, H, D); position: an int or a
    0-d int tensor (the same for the batch). Placed slices (``Blocks``)
    take the write in each block that owns the slot (a tensor position is
    read to the host once)."""
    if isinstance(stack_k, Blocks):
        return _write_blocks(stack_k, stack_v, pos_arr, k_new, v_new,
                             int(position))
    B, s_cache = stack_k.shape[:2]
    pos = position_tensor(position, stack_k.device)
    slot = decode_slot(pos, s_cache).reshape(1)
    stack_k.index_copy_(1, slot, k_new.to(stack_k.dtype))
    stack_v.index_copy_(1, slot, v_new.to(stack_v.dtype))
    pos_arr.index_copy_(1, slot, pos.to(torch.int32).reshape(1, 1)
                        .expand(B, 1).contiguous())
    return stack_k, stack_v, pos_arr


def _write_blocks(k: Blocks, v: Blocks, pos: Blocks, k_new: torch.Tensor,
                  v_new: torch.Tensor, position: int
                  ) -> Tuple[Blocks, Blocks, Blocks]:
    """``write_token`` on placed slices: every stored block whose slots
    hold ``position``'s slot takes its batch rows of the token (copied to
    its device) and the position; every other block is left untouched."""
    slot = decode_slot(position, k.shape[1])
    for s in k.stored():
        rows, cols = k.region(s)[:2]
        if not cols.start <= slot < cols.stop:
            continue
        at = slot - cols.start
        k.parts[s].narrow(1, at, 1).copy_(k_new[rows])
        v.parts[s].narrow(1, at, 1).copy_(v_new[rows])
        pos.parts[s].narrow(1, at, 1).fill_(position)
    return k, v, pos


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
