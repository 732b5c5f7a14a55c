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
across batch blocks, in shard order (JAX's ``pmax`` / ``psum``). The
shards are views of the one cache tensor, as ``dist/mesh.py::place`` lays
out shards that share a card, so one card holds S shards at the cost of
one cache and ``KV.write_token`` keeps writing in place. Every shard of a
bound mesh must sit on one device: a mesh of several cards would need the
cache in per-card blocks, each decode write going to the block that owns
its slot (ROADMAP, Queue 3, "per-card KV-cache blocks").

Split-K decode is ``jnp`` in the JAX package (no Pallas kernel), so it is
plain PyTorch here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.analysis.audit import note_collective
from repro_torch.dist.sharding import Part, _axes, _group_size

_NEG = -1e30

_mesh = None
_batch_part: Part = None     # spec entry of the cache's batch dim
_seq_part: Part = None       # spec entry of the cache's sequence dim


def configure(mesh, batch_part: Part, seq_part: Part) -> None:
    """Bind (or, with ``configure(None, None, None)``, unbind) the split-K
    decode path. ``batch_part`` / ``seq_part`` are the spec entries of the
    cache's batch and sequence dims (``lm_cache_specs``). Raises
    ValueError for a mesh whose shards sit on more than one device or an
    axis the mesh lacks."""
    global _mesh, _batch_part, _seq_part
    if mesh is not None:
        if len(set(mesh.devices)) > 1:
            raise ValueError(
                f"split-K decode over a mesh of {len(set(mesh.devices))} "
                "devices needs per-card KV-cache blocks (ROADMAP, Queue 3, "
                "'per-card KV-cache blocks for a mesh of several cards'); "
                "bind a mesh whose shards share one device")
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


def _combine(shards, v_shards, qg_dtype):
    """JAX's split-K arithmetic over one batch block's sequence shards, in
    shard order: the max over every shard first, then each shard's
    exp(logits - max) (zeroed where masked: an all-masked shard would give
    exp(0) = 1), the denominators and weighted values summed, the
    denominator floored at 1e-30."""
    m = None
    for logits, _ in shards:
        m_loc = torch.amax(logits, dim=-1)                    # (B, K, G, 1)
        m = m_loc if m is None else torch.maximum(m, m_loc)
    denom = num = None
    for (logits, mask), v in zip(shards, v_shards):
        p = torch.exp(logits - m[..., None])
        p = torch.where(mask, p, 0.0)
        d = torch.sum(p, dim=-1)                              # (B, K, G, 1)
        n = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
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
    part = _partials(qg, k, v, kv_pos, kv_valid, q_pos, window, scale=scale,
                     softcap=softcap)
    return _combine([part], [v], qg.dtype)


def flash_decode_attention(qg, k, v, kv_pos, kv_valid, q_pos, window: int,
                           scale: float,
                           attn_softcap: Optional[float] = None):
    """Decode attention with the configured split-K sharding. Shapes as in
    :func:`_local_attention`, global; returns (B, 1, Hkv, G, Dh) in
    ``qg``'s dtype. Without a bound mesh this is :func:`_local_attention`.
    With one, the batch splits into ``nb`` blocks over the batch axes and
    the sequence into ``ns`` blocks over the sequence axes (each a view of
    the cache); each batch block combines its ``ns`` sequence shards, and
    the blocks are concatenated in order. Each combine reports its logical
    cross-shard bytes to the audit: the max, the denominators and the
    weighted values every sequence shard contributes."""
    scale = float(scale)
    if _mesh is None:
        return _local_attention(qg, k, v, kv_pos, kv_valid, q_pos, window,
                                scale=scale, softcap=attn_softcap)
    nb = _group_size(_mesh.shape, _axes(_batch_part))
    ns = _group_size(_mesh.shape, _axes(_seq_part))
    B, S = kv_pos.shape
    if B % nb or S % ns:
        raise ValueError(f"cache (B={B}, S={S}) does not split into {nb} "
                         f"batch x {ns} sequence blocks")
    b, s = B // nb, S // ns
    outs = []
    for i in range(nb):
        rows = slice(i * b, (i + 1) * b)
        shards, v_shards = [], []
        for j in range(ns):
            cols = slice(j * s, (j + 1) * s)
            shards.append(_partials(
                qg[rows], k[rows, cols], v[rows, cols], kv_pos[rows, cols],
                kv_valid[rows, cols], q_pos[rows], window, scale=scale,
                softcap=attn_softcap))
            v_shards.append(v[rows, cols])
        if ns > 1:
            B_, _, K_, G_, D_ = qg[rows].shape
            per_shard = B_ * K_ * G_ * (2 + D_) * 4   # max, denom, num (f32)
            note_collective("all-reduce", ns * per_shard)
        outs.append(_combine(shards, v_shards, qg.dtype))
    return outs[0] if nb == 1 else torch.cat(outs, dim=0)
