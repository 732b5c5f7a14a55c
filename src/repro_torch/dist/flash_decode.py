"""Split-K ("flash-decoding") attention over a sequence-sharded KV cache
(port of ``repro.dist.flash_decode``).

On long-context decode (``long_500k``: B = 1, a 524,288-slot cache) the
cache splits its sequence dim over ``model`` (``dist/sharding.py``
``lm_cache_specs``). Each shard attends over its own slots, and the shards
exchange only the (B, Hkv, G) running max and denominator and the (B, Hkv,
G, Dh) weighted-value partials: a log-sum-exp combine, the split-K
reduction of flash-decoding with the splits on different shards.

A caller binds the path with :func:`configure`; ``models/transformer.py``
``forward_decode`` takes it when :func:`enabled`. The mesh is the port's
one-process :class:`~repro_torch.dist.mesh.Mesh`. Shard (i, j) of a
(data, model) mesh holds batch block i and sequence block j; the max and
the sums combine over the sequence blocks j of each batch block i, never
across batch blocks, in shard order (JAX's ``pmax`` / ``psum``).

The cache comes in one of two forms:

* placed (``models/transformer.py::init_cache(..., mesh=mesh)``, or
  ``forward_prefill`` / ``generate`` with ``mesh=``): k, v and pos are
  :class:`~repro_torch.dist.mesh.Blocks`, one block per shard on that
  shard's device, as JAX's ``shard_map`` sees them. Each shard's logits and
  partials are computed on its own device over its own block; the query
  rows go there (a (b, 1, Hkv, G, Dh) copy), the local max, denominators
  and weighted values come to the batch block's merge device (its first
  shard's device) and the global max goes back, in shard order. The batch
  blocks are concatenated on ``devices[0]``, where the weights live. On a
  mesh whose shards share one device the blocks are views of one cache, so
  S shards cost one cache and the arithmetic is the unplaced form's, bit
  for bit.
* unplaced (a plain tensor cache, e.g. the launcher's count on ``meta``):
  the shards are views of the one tensor, wherever the mesh puts them.

Split-K decode is ``jnp`` in the JAX package (no Pallas kernel), so it is
plain PyTorch here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.analysis.audit import note_collective
from repro_torch.dist.mesh import Blocks
from repro_torch.dist.sharding import Part, _axes, _group_size

_NEG = -1e30

_mesh = None
_batch_part: Part = None     # spec entry of the cache's batch dim
_seq_part: Part = None       # spec entry of the cache's sequence dim


def configure(mesh, batch_part: Part, seq_part: Part) -> None:
    """Bind (or, with ``configure(None, None, None)``, unbind) the split-K
    decode path. ``batch_part`` / ``seq_part`` are the spec entries of the
    cache's batch and sequence dims (``lm_cache_specs``). The shards may
    sit on any devices. Raises ValueError for an axis the mesh lacks."""
    global _mesh, _batch_part, _seq_part
    if mesh is not None:
        for ax in _axes(batch_part) + _axes(seq_part):
            if ax not in mesh.axis_names:
                raise ValueError(f"axis {ax!r} is not in the mesh's "
                                 f"{mesh.axis_names}")
    _mesh, _batch_part, _seq_part = mesh, batch_part, seq_part


def enabled() -> bool:
    return _mesh is not None


def _partials(qg, k, v, kv_pos, kv_valid, q_pos, window: int, *,
              scale: float, softcap: Optional[float]):
    """One shard's masked float32 logits (B, Hkv, G, 1, S_loc) and mask."""
    f32 = torch.float32
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.to(f32),
                          k.to(f32)) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    causal = kv_pos[:, None, :] <= q_pos[:, :, None]          # (B, 1, S)
    if window > 0:
        causal = causal & (q_pos[:, :, None] - kv_pos[:, None, :] < window)
    mask = (causal & kv_valid[:, None, :])[:, None, None, :, :]
    return torch.where(mask, logits, _NEG), mask


def _combine(shards, qg_dtype, merge):
    """JAX's split-K arithmetic over one batch block's sequence shards, in
    shard order: the max over every shard first (each local max copied to
    ``merge``, the global max back to each shard), then each shard's
    exp(logits - max) on its own device (zeroed where masked: an all-masked
    shard would give exp(0) = 1), the denominators and weighted values
    copied to ``merge`` and summed there, the denominator floored at 1e-30.
    ``shards``: (logits, mask, v) per shard. On one device every copy is a
    no-op."""
    m = None
    for logits, _, _ in shards:
        m_loc = torch.amax(logits, dim=-1).to(merge)          # (B, K, G, 1)
        m = m_loc if m is None else torch.maximum(m, m_loc)
    denom = num = None
    for logits, mask, v in shards:
        p = torch.exp(logits - m.to(logits.device)[..., None])
        p = torch.where(mask, p, 0.0)
        d = torch.sum(p, dim=-1).to(merge)                    # (B, K, G, 1)
        n = torch.einsum("bkgqs,bskd->bqkgd", p,
                         v.to(torch.float32)).to(merge)
        denom = d if denom is None else denom + d
        num = n if num is None else num + n
    denom = torch.clamp(denom, min=1e-30)
    # denom (B, K, G, 1) -> broadcast over num (B, 1, K, G, D)
    return (num / denom.permute(0, 3, 1, 2)[..., None]).to(qg_dtype)


def _local_attention(qg, k, v, kv_pos, kv_valid, q_pos, window: int, *,
                     scale: float, softcap: Optional[float]):
    """Attention of one batch block over its whole cache (no sequence
    split): JAX's ``_local_attention`` with ``seq_axes=()``.

    qg:       (B, 1, Hkv, G, Dh) queries, grouped per KV head
    k, v:     (B, S, Hkv, Dh)
    kv_pos:   (B, S) absolute position per slot (-1 = empty)
    kv_valid: (B, S) slot validity
    q_pos:    (B, 1) query position; window: int (<= 0: full causal)
    """
    logits, mask = _partials(qg, k, v, kv_pos, kv_valid, q_pos, window,
                             scale=scale, softcap=softcap)
    return _combine([(logits, mask, v)], qg.dtype, qg.device)


def flash_decode_attention(qg, k, v, kv_pos, kv_valid, q_pos, window: int,
                           scale: float,
                           attn_softcap: Optional[float] = None):
    """Decode attention with the configured split-K sharding. Shapes as in
    :func:`_local_attention`, global; returns (B, 1, Hkv, G, Dh) in
    ``qg``'s dtype. Without a bound mesh this is :func:`_local_attention`.
    With one, the batch splits into ``nb`` blocks over the batch axes and
    the sequence into ``ns`` blocks over the sequence axes; each batch
    block combines its ``ns`` sequence shards, and the blocks are
    concatenated in order. ``k``, ``v`` and ``kv_pos`` are tensors (each
    shard a view) or, for a placed cache, :class:`Blocks` on the bound mesh
    (``kv_valid`` None: each block's ``pos >= 0``). Each combine reports
    its logical cross-shard bytes to the audit."""
    scale = float(scale)
    if _mesh is None:
        if isinstance(k, Blocks):
            raise ValueError("a placed cache attends through split-K: bind "
                             "its mesh with configure(), or gather it")
        return _local_attention(qg, k, v, kv_pos, kv_valid, q_pos, window,
                                scale=scale, softcap=attn_softcap)
    if isinstance(k, Blocks):
        blocks, out_dev = _block_cells(k, v, kv_pos), _mesh.devices[0]
    else:
        blocks = _view_cells(k, v, kv_pos, kv_valid, qg.device)
        out_dev = qg.device
    b = qg.shape[0] // len(blocks)
    outs = []
    for i, (merge, cells) in enumerate(blocks):
        rows = slice(i * b, (i + 1) * b)
        shards = []
        for dev, kb, vb, pb, valid in cells:
            logits, mask = _partials(
                qg[rows].to(dev), kb, vb, pb, valid, q_pos[rows].to(dev),
                window, scale=scale, softcap=attn_softcap)
            shards.append((logits, mask, vb))
        if len(cells) > 1:    # the max, denominators, weighted values (f32)
            B_, _, K_, G_, D_ = qg[rows].shape
            note_collective("all-reduce",
                            len(cells) * B_ * K_ * G_ * (2 + D_) * 4)
        outs.append(_combine(shards, qg.dtype, merge).to(out_dev))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def _view_cells(k, v, kv_pos, kv_valid, dev):
    """Per batch block: (``dev``, its sequence shards), each (``dev``, the
    views of k, v, kv_pos, kv_valid): an unplaced cache stays on its own
    device ``dev``, whatever devices the mesh names."""
    nb = _group_size(_mesh.shape, _axes(_batch_part))
    ns = _group_size(_mesh.shape, _axes(_seq_part))
    B, S = kv_pos.shape
    if B % nb or S % ns:
        raise ValueError(f"cache (B={B}, S={S}) does not split into {nb} "
                         f"batch x {ns} sequence blocks")
    b, s = B // nb, S // ns
    return [(dev, [(dev, k[rows, cols], v[rows, cols], kv_pos[rows, cols],
                    kv_valid[rows, cols])
                   for cols in (slice(j * s, (j + 1) * s)
                                for j in range(ns))])
            for rows in (slice(i * b, (i + 1) * b) for i in range(nb))]


def _block_cells(k: Blocks, v: Blocks, kv_pos: Blocks):
    """Per batch block: (its merge device, its sequence shards), each
    (device, k, v, pos, pos >= 0) of the first shard, in shard order, that
    holds the block; the merge device is the batch block's first shard's.
    The cache must be placed on the bound mesh by the bound spec."""
    if k.mesh != _mesh or tuple(map(_axes, k.spec[:2])) != (
            _axes(_batch_part), _axes(_seq_part)):
        raise ValueError(f"cache placed on {k.mesh.shape} by {k.spec[:2]}; "
                         f"split-K is bound to {_mesh.shape} by "
                         f"{(_batch_part, _seq_part)}")
    b, s = k.parts[0].shape[:2]
    owner = {}                    # (batch block, sequence block) -> shard
    for sh, st in enumerate(k.starts):
        owner.setdefault((st[0] // b, st[1] // s), sh)
    devs = _mesh.devices
    out = []
    for i in range(k.shape[0] // b):
        shards = [owner[i, j] for j in range(k.shape[1] // s)]
        out.append((devs[min(shards)], [
            (devs[sh], k.parts[sh], v.parts[sh], kv_pos.parts[sh],
             kv_pos.parts[sh] >= 0) for sh in shards]))
    return out
