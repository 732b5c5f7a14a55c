"""Mesh-resident corpus for the sharded serving flavors (port of
``repro.retrieval.sharded``).

* :class:`ShardedCorpus` owns the placement: the doc dim is padded to a
  multiple of the mesh's shard count and split over every mesh axis
  (``dist.mesh.corpus_specs``), so shard ``s`` owns the contiguous global
  rows ``[s * docs_per_shard, (s + 1) * docs_per_shard)`` and a real doc's
  padded-global id is its original id. Where shards share a device each
  shard is a view of the one padded tensor.
* ``valid_docs`` counts the genuine docs per shard (the trailing shards of
  an odd-size corpus own fewer, possibly zero); the sharded steps clamp
  their global-id math against it (``service._shard_global_ids``).
* :func:`route_candidates` / :func:`route_batch` / :func:`route_aligned`
  are the host routing tables (numpy, the JAX module's own code): global
  candidate ids to per-shard local slot lists.

Pad rows carry an all-False token mask and zero embeddings, so they never
contribute score mass even before the id clamp drops them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.dist.mesh import Mesh, Sharded, corpus_axes, corpus_specs, \
    place
from repro_torch.kernels.quant import CORPUS_FORMATS, quantize


@dataclasses.dataclass(frozen=True)
class ShardedCorpus:
    """A (C, L, M) token index resident on a mesh.

    ``embs``/``mask`` (and ``pooled`` when present) are :class:`Sharded`
    values whose doc dim splits over every mesh axis; ``n_docs`` is the
    true corpus size, ``docs_per_shard * n_shards`` the padded one. For
    ``int8``/``residual`` each part of ``embs`` is a ``QuantTokens`` whose
    payload and planes split like a dense corpus and whose codebook every
    shard holds whole."""

    embs: Sharded                        # (C_pad, L, M) f32 | bf16 | quant
    mask: Sharded                        # (C_pad, L) bool, pads all-False
    mesh: Mesh
    n_docs: int                          # genuine docs (C)
    n_shards: int
    docs_per_shard: int                  # C_pad // n_shards
    valid_docs: np.ndarray               # (n_shards,) i32 genuine docs/shard
    pooled: Optional[Sharded] = None     # (C_pad, M) two-phase summaries
    router: Optional[object] = None      # retrieval.corpus.CentroidRouter
    fmt: str = "bf16"                    # resident format (CORPUS_FORMATS)

    @property
    def padded_docs(self) -> int:
        return self.n_shards * self.docs_per_shard

    def valid_docs_device(self) -> torch.Tensor:
        """(n_shards,) int32 on the merge device: the clamp table the
        sharded steps index by shard number."""
        return torch.as_tensor(self.valid_docs, dtype=torch.int32,
                               device=self.mesh.devices[0])


def _pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return x
    return torch.cat([x, torch.zeros((pad, *x.shape[1:]), dtype=x.dtype,
                                     device=x.device)])


def shard_corpus(embs, mask, mesh: Mesh, *, pooled=None, router=None,
                 n_centroids: int = 0, router_iters: int = 10,
                 router_seed: int = 0,
                 corpus_format: str = "bf16") -> ShardedCorpus:
    """Pad the doc dim to the mesh's shard count and place every corpus
    field by ``corpus_specs``.

    ``embs``/``mask`` are numpy-convertible or tensors; a tensor is padded
    where it lies and, when it already sits on the mesh's one device and
    needs no pad, the shards are views of it (no copy). A bfloat16 corpus
    stays bfloat16, other dtypes become float32. ``corpus_format``
    'int8' / 'residual' encodes the padded corpus (``kernels.quant``) on
    the first shard's device, so pad rows encode with scale 0 and decode
    to zeros (int8) or ``centroids[0]`` (residual); their all-False mask
    keeps them out of every max. 'residual' needs the router's centroids as
    its codebook and builds an 8-centroid router when none is given.
    ``n_centroids > 0`` builds the shard-local stage-1 centroid router over
    the same contiguous blocks; a prebuilt ``router`` may be passed
    instead. Its tensors live on the merge device (``devices[0]``)."""
    if corpus_format not in CORPUS_FORMATS:
        raise ValueError(f"unknown corpus format {corpus_format!r}; "
                         f"expected one of {CORPUS_FORMATS}")
    src = embs if isinstance(embs, torch.Tensor) else torch.as_tensor(
        np.asarray(embs))
    if src.dtype != torch.bfloat16:
        src = src.to(torch.float32)
    dmask = (mask if isinstance(mask, torch.Tensor)
             else torch.as_tensor(np.asarray(mask, bool))).to(torch.bool)
    if src.dim() != 3 or dmask.dim() != 2 \
            or tuple(src.shape[:2]) != tuple(dmask.shape):
        raise ValueError("corpus must be (C, L, M) embs + (C, L) mask")
    C = src.shape[0]
    n_shards = 1
    for ax in corpus_axes(mesh):
        n_shards *= mesh.shape[ax]
    c_loc = -(-max(C, 1) // n_shards)            # ceil; >=1 so shapes stay real
    pad = n_shards * c_loc - C
    src, dmask = _pad_rows(src, pad), _pad_rows(dmask, pad)
    valid = np.clip(C - c_loc * np.arange(n_shards), 0, c_loc).astype(np.int32)
    specs = corpus_specs(mesh)
    merge = mesh.devices[0]
    pooled_dev = None
    if pooled is not None:
        p = pooled if isinstance(pooled, torch.Tensor) else torch.as_tensor(
            np.asarray(pooled, np.float32))
        pooled_dev = place(_pad_rows(p.to(torch.float32), pad), mesh,
                           specs["pooled"])
    if corpus_format == "residual" and router is None and not n_centroids:
        n_centroids = 8  # the residual codebook IS the router's centroids
    if router is None and n_centroids:
        # late import: corpus.py is the facade above this module
        from repro_torch.retrieval.corpus import build_router
        router = build_router(src, dmask, n_shards=n_shards,
                              docs_per_shard=c_loc, n_centroids=n_centroids,
                              n_iters=router_iters, seed=router_seed,
                              valid_docs=valid, device=merge)
    if corpus_format == "residual" and router is None:
        raise ValueError(
            "corpus_format='residual' needs a centroid codebook: pass a "
            "prebuilt router or n_centroids > 0")
    if router is not None:
        router = dataclasses.replace(
            router, centroids=router.centroids.to(merge, torch.float32),
            shard_mass=router.shard_mass.to(merge, torch.float32))
    if corpus_format == "bf16":
        resident = src
    else:
        resident = quantize(src, corpus_format, device=merge,
                            codebook=None if corpus_format != "residual"
                            else router.centroids)
    return ShardedCorpus(
        embs=place(resident, mesh, specs["embs"]),
        mask=place(dmask, mesh, specs["mask"]), mesh=mesh, n_docs=C,
        n_shards=n_shards, docs_per_shard=c_loc, valid_docs=valid,
        pooled=pooled_dev, router=router, fmt=corpus_format)


# ---------------------------------------------------------------------------
# Host routing tables (numpy; the JAX module's code)
# ---------------------------------------------------------------------------

def _routing_placement(cand_ids: np.ndarray, docs_per_shard: int,
                       n_shards: int, n_local: int):
    """The one gid -> (row, shard, slot) placement the routing functions
    share: candidate gid lands on shard ``gid // docs_per_shard``, packed
    to the front of that shard's slot list in the query's original
    candidate order. Returns (rows, cols, shards, slots) index arrays, so
    ``out[rows, shards, slots] = f(cand_ids[rows, cols])``."""
    cand_ids = np.asarray(cand_ids)
    rows, cols = np.nonzero(cand_ids >= 0)
    gids = cand_ids[rows, cols]
    if gids.size and int(gids.max()) >= n_shards * docs_per_shard:
        raise ValueError(
            f"candidate id {int(gids.max())} outside the padded corpus "
            f"({n_shards * docs_per_shard} rows)")
    shards = gids // docs_per_shard
    # Stable grouping key (row, shard): rank within the group = index minus
    # the group's first index, found by searchsorted on the sorted keys.
    key = rows.astype(np.int64) * n_shards + shards
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    rank = np.empty_like(order)
    rank[order] = (np.arange(len(order))
                   - np.searchsorted(key_sorted, key_sorted, side="left"))
    if rank.size and int(rank.max()) >= n_local:
        i = rows[int(np.argmax(rank))]
        raise ValueError(
            f"query {int(i)} routes more than n_local={n_local} candidates "
            "to one shard; raise n_local (it may go up to N)")
    return rows, cols, shards, rank


def route_candidates(cand_ids: np.ndarray, docs_per_shard: int,
                     n_shards: int, *, n_local: Optional[int] = None,
                     ) -> np.ndarray:
    """Global ids -> per-shard local slots: cand_ids (B, N) with -1
    padding -> (B, n_shards, n_local) int32, -1 padded, holding the local
    row ``gid % docs_per_shard`` packed to the front of the shard's list in
    the query's candidate order. ``n_local`` defaults to N (every candidate
    on one shard), which keeps the routed shape fixed per candidate
    bucket."""
    cand_ids = np.asarray(cand_ids)
    B, N = cand_ids.shape
    n_local = N if n_local is None else n_local
    rows, cols, shards, slots = _routing_placement(
        cand_ids, docs_per_shard, n_shards, n_local)
    out = np.full((B, n_shards, n_local), -1, np.int32)
    out[rows, shards, slots] = cand_ids[rows, cols] % docs_per_shard
    return out


def route_batch(cand_ids: np.ndarray, payloads, docs_per_shard: int,
                n_shards: int, *, n_local: Optional[int] = None):
    """Route ids plus any number of aligned (B, N, ...) payloads with one
    placement computation. Returns ``(cand_local, [routed payloads...])``,
    payloads zero-filled where ``cand_local`` is -1."""
    cand_ids = np.asarray(cand_ids)
    B, N = cand_ids.shape
    n_local = N if n_local is None else n_local
    rows, cols, shards, slots = _routing_placement(
        cand_ids, docs_per_shard, n_shards, n_local)
    cand_local = np.full((B, n_shards, n_local), -1, np.int32)
    cand_local[rows, shards, slots] = cand_ids[rows, cols] % docs_per_shard
    routed = []
    for values in payloads:
        values = np.asarray(values)
        out = np.zeros((B, n_shards, n_local) + values.shape[2:],
                       values.dtype)
        out[rows, shards, slots] = values[rows, cols]
        routed.append(out)
    return cand_local, routed


def route_aligned(values: np.ndarray, cand_ids: np.ndarray,
                  cand_local: np.ndarray, docs_per_shard: int) -> np.ndarray:
    """Carry per-candidate payloads (e.g. the (B, N, T) support bounds)
    through the routing ``route_candidates`` applied to the ids: values
    (B, N, ...) -> (B, n_shards, n_local, ...), zero where cand_local is
    -1."""
    values = np.asarray(values)
    B, n_shards, n_local = cand_local.shape
    rows, cols, shards, slots = _routing_placement(
        cand_ids, docs_per_shard, n_shards, n_local)
    out = np.zeros((B, n_shards, n_local) + values.shape[2:], values.dtype)
    out[rows, shards, slots] = values[rows, cols]
    return out
