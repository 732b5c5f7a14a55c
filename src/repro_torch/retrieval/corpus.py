"""Corpus facade, candidate gather and centroid router (port of the
single-device part of ``repro.retrieval.corpus``).

* :func:`gather_tokens` - THE candidate-embedding gather: rank-general,
  -1 ids come back fully masked, a ``QuantTokens`` corpus is gathered leaf
  by leaf so the moved bytes stay compressed. ``index`` re-exports it and
  ``service.gather_candidates`` delegates here.
* :class:`CentroidRouter` / :func:`build_router` - spherical k-means over
  doc-pooled embeddings (a verbatim numpy copy, so the centroids are
  bit-equal to the JAX package's) plus the per-(centroid, shard) doc-mass
  table; :func:`route_mass` / :func:`route_quotas` turn query affinities
  into integer per-shard quotas that always sum to the budget, and
  :func:`validate_quotas` raises instead of clamping.
* :class:`Corpus` / :func:`build_corpus` - the corpus facade the serving
  engine holds, in one of the resident formats of ``kernels.quant`` (the
  router's centroids are the residual format's codebook): the
  single-device corpus (``mesh=None``) or the mesh-resident
  ``sharded.ShardedCorpus`` placement, with one attribute surface.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.dist.mesh import Mesh
from repro_torch.kernels.quant import CORPUS_FORMATS, corpus_take, quantize
from repro_torch.retrieval.sharded import shard_corpus


def gather_tokens(embs, mask: torch.Tensor, doc_ids: torch.Tensor):
    """Gather candidate token embeddings by doc id.

    embs (C, L, M) or a ``QuantTokens``, mask (C, L), doc_ids (..., N) with
    -1 padding -> (..., N, L, M) embeddings (``QuantTokens`` for a
    quantized corpus) + (..., N, L) mask, all-False for -1 ids."""
    safe = torch.clamp(doc_ids, min=0)
    docs = corpus_take(embs, safe, axis=0)
    dmask = mask[safe] & (doc_ids >= 0)[..., None]
    return docs, dmask


# ---------------------------------------------------------------------------
# Centroid router
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CentroidRouter:
    """Router state: unit centroids over doc-pooled embeddings plus the
    (centroid, shard) doc-mass table."""

    centroids: torch.Tensor   # (Kc, M) f32 unit rows
    shard_mass: torch.Tensor  # (Kc, n_shards) f32, docs per (centroid, shard)
    valid_docs: np.ndarray    # (n_shards,) i32, genuine docs per shard

    @property
    def n_centroids(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_shards(self) -> int:
        return self.shard_mass.shape[1]

    def route(self, queries, n_total: int, *,
              n_local: Optional[int] = None,
              healthy: Optional[np.ndarray] = None) -> np.ndarray:
        """(B, T, M) queries -> (B, n_shards) integer quotas summing
        exactly to ``n_total`` per query. Raises ``ValueError`` (never
        clamps) when a quota exceeds a shard's ``valid_docs`` or the
        per-shard capacity ``n_local``. ``healthy`` (n_shards,) bool
        re-routes a failed shard's quota mass (see :func:`route_quotas`)."""
        q = torch.as_tensor(queries, dtype=torch.float32,
                            device=self.centroids.device)
        mass = route_mass(q, self.centroids, self.shard_mass)
        h = None if healthy is None else torch.as_tensor(
            np.asarray(healthy, bool), device=mass.device)
        quotas = route_quotas(mass, n_total, healthy=h).cpu().numpy()
        validate_quotas(quotas, self.valid_docs, n_local=n_local)
        return quotas


def validate_quotas(quotas: np.ndarray, valid_docs: np.ndarray, *,
                    n_local: Optional[int] = None) -> None:
    """Loud-failure quota check: a routed quota larger than a shard's
    genuine doc count (or the slot capacity) is a configuration error."""
    quotas = np.asarray(quotas)
    valid_docs = np.asarray(valid_docs)
    peak = quotas.max(axis=0) if quotas.ndim == 2 else quotas
    for s, (q, v) in enumerate(zip(peak, valid_docs)):
        if q > v:
            raise ValueError(
                f"routed quota {int(q)} for shard {s} exceeds its "
                f"valid_docs={int(v)}; lower n_total or rebalance the "
                "corpus (quotas are never silently clamped)")
    if n_local is not None and peak.size and int(peak.max()) > n_local:
        s = int(np.argmax(peak))
        raise ValueError(
            f"routed quota {int(peak.max())} for shard {s} exceeds the "
            f"compiled per-shard capacity n_local={int(n_local)}; raise "
            "n_local or lower n_total")


def build_router(embs, mask, *, n_shards: int, docs_per_shard: int,
                 n_centroids: int = 8, n_iters: int = 10, seed: int = 0,
                 valid_docs: Optional[np.ndarray] = None,
                 device="cuda") -> CentroidRouter:
    """Build the centroid router on the host (index construction, not the
    query path) and place it on ``device``.

    Spherical k-means (Lloyd, ``n_iters`` fixed iterations, deterministic
    under ``seed``) over the doc-pooled unit embeddings of every doc with
    at least one valid token; ``shard_mass[c, s]`` counts the docs of
    cluster ``c`` on shard ``s`` (shard of doc = row // docs_per_shard).
    Empty clusters keep their centroid and zero mass; docs with no valid
    token carry no mass."""
    embs = _host(embs).astype(np.float32)
    mask = _host(mask).astype(bool)
    C, _, M = embs.shape
    if valid_docs is None:
        valid_docs = np.clip(C - docs_per_shard * np.arange(n_shards),
                             0, docs_per_shard).astype(np.int32)
    denom = np.maximum(mask.sum(1, keepdims=True), 1).astype(np.float32)
    pooled = (embs * mask[:, :, None]).sum(1) / denom
    pooled /= np.maximum(np.linalg.norm(pooled, axis=-1, keepdims=True), 1e-9)
    ids = np.nonzero(mask.any(1))[0]
    k = int(max(min(n_centroids, len(ids)), 1))
    if len(ids) == 0:
        cents = np.zeros((k, M), np.float32)
        assign = np.zeros((0,), np.int64)
    else:
        rng = np.random.default_rng(seed)
        cents = pooled[ids[rng.choice(len(ids), size=k, replace=False)]].copy()
        pts = pooled[ids]
        for _ in range(max(n_iters, 1)):
            assign = np.argmax(pts @ cents.T, axis=1)
            for c in range(k):
                sel = pts[assign == c]
                if len(sel):
                    v = sel.mean(0)
                    nrm = np.linalg.norm(v)
                    if nrm > 1e-9:
                        cents[c] = v / nrm
        assign = np.argmax(pts @ cents.T, axis=1)
    shard_mass = np.zeros((k, n_shards), np.float32)
    if len(ids):
        np.add.at(shard_mass, (assign, ids // docs_per_shard), 1.0)
    dev = torch.device(device)
    return CentroidRouter(centroids=torch.tensor(cents, device=dev),
                          shard_mass=torch.tensor(shard_mass, device=dev),
                          valid_docs=np.asarray(valid_docs, np.int32))


def route_mass(queries: torch.Tensor, centroids: torch.Tensor,
               shard_mass: torch.Tensor) -> torch.Tensor:
    """Routed per-shard candidate mass: queries (B, T, M), centroids
    (Kc, M), shard_mass (Kc, S) -> (B, S). Per-token centroid affinity
    relu(<q_t, c_k>) summed over tokens, then pushed through the mass
    table. A zero-centroid router yields all-zero mass. (JAX's
    ``n_probe`` top-centroid cut has no caller here and is not ported.)"""
    B = queries.shape[0]
    S = shard_mass.shape[1]
    if centroids.shape[0] == 0:
        return torch.zeros((B, S), dtype=torch.float32,
                           device=queries.device)
    aff = torch.einsum("btm,km->btk", queries.to(torch.float32),
                       centroids.to(torch.float32))
    aff = torch.relu(aff).sum(dim=1)                              # (B, Kc)
    return aff @ shard_mass.to(torch.float32)                      # (B, S)


def route_quotas(mass: torch.Tensor, n_total: int,
                 healthy: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Integer per-shard quotas from routed mass: (B, S) >= 0 -> (B, S)
    int32 with ``sum(quotas[b]) == n_total`` exactly for every query.
    Largest-remainder rounding of the proportional ideal; larger
    fractional part first, lower shard index on exact ties. All-zero mass
    rows fall back to uniform shares.

    ``healthy`` (S,) bool zeroes the mass of unhealthy shards before
    normalisation, so their share is re-routed onto the survivors; with no
    healthy mass the fallback is uniform over the healthy set, and with no
    healthy shard at all it is the unmasked uniform fallback."""
    mass = torch.clamp(mass.to(torch.float32), min=0.0)
    B, S = mass.shape
    dev = mass.device

    def f32(v):   # constants enter as float32, as JAX's jnp.float32 ones do
        return torch.tensor(v, dtype=torch.float32, device=dev)

    if healthy is None:
        tot = mass.sum(dim=-1, keepdim=True)
        frac = torch.where(tot > 0, mass / torch.clamp(tot, min=1e-30),
                           f32(1.0 / S))
    else:
        h = torch.as_tensor(healthy, device=dev).reshape(S).to(torch.bool)
        h = h.to(torch.float32)
        h = torch.where(h.sum() > 0, h, torch.ones((S,), device=dev))
        mass = mass * h[None, :]
        tot = mass.sum(dim=-1, keepdim=True)
        nh = h.sum()
        fallback = torch.where(nh >= S, f32(1.0 / S).expand(S),
                               h / torch.clamp(nh, min=1.0))
        frac = torch.where(tot > 0, mass / torch.clamp(tot, min=1e-30),
                           fallback[None, :])
    ideal = frac * f32(n_total)
    base = torch.floor(ideal).to(torch.int32)
    rem = torch.clamp(n_total - base.sum(dim=-1), 0, S)            # (B,)
    prio = (ideal - torch.floor(ideal)) \
        - torch.arange(S, device=dev).to(torch.float32) * f32(1e-6)
    order = torch.argsort(-prio, dim=-1, stable=True)              # (B, S)
    bonus = (torch.arange(S, device=dev)[None, :] < rem[:, None]).to(
        torch.int32)
    out = torch.zeros((B, S), dtype=torch.int32, device=dev)
    return out.scatter_add(1, order, bonus) + base


# ---------------------------------------------------------------------------
# Corpus facade
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Corpus:
    """One attribute surface for both placements: ``mesh=None`` is the
    single-device corpus (one shard owning every document); with a mesh,
    ``embs``/``mask``/``pooled`` are the ``ShardedCorpus`` placement
    (``dist.mesh.Sharded`` values, doc dim over every axis, ragged tail
    padded and counted in ``valid_docs``)."""

    embs: object                 # (C_pad, L, M) f32 | bf16 tensor,
                                 #   QuantTokens, or Sharded of either
    mask: object                 # (C_pad, L) bool tensor or Sharded
    n_docs: int
    n_shards: int
    docs_per_shard: int
    valid_docs: np.ndarray       # (n_shards,) i32
    router: Optional[CentroidRouter] = None
    fmt: str = "bf16"            # resident format (CORPUS_FORMATS)
    mesh: Optional[Mesh] = None
    pooled: object = None        # (C_pad, M) two-phase summaries

    @property
    def padded_docs(self) -> int:
        return self.n_shards * self.docs_per_shard

    def valid_docs_device(self) -> torch.Tensor:
        """(n_shards,) int32 on the corpus's (merge) device."""
        dev = (self.mask.device if self.mesh is None
               else self.mesh.devices[0])
        return torch.as_tensor(self.valid_docs, dtype=torch.int32,
                               device=dev)

    def router_arrays(self):
        """(centroids, shard_mass) for the routed serving step; zero-row
        placeholders when no router was built (route_mass then yields zero
        mass and quotas fall back to uniform)."""
        if self.router is not None:
            return self.router.centroids, self.router.shard_mass
        dev = (self.mask.device if self.mesh is None
               else self.mesh.devices[0])
        return (torch.zeros((0, self.embs.shape[2]), dtype=torch.float32,
                            device=dev),
                torch.zeros((0, self.n_shards), dtype=torch.float32,
                            device=dev))


def _host(x) -> np.ndarray:
    """numpy view of a numpy-convertible or tensor operand (bf16, which
    numpy lacks, is widened to f32 exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def build_corpus(embs, mask, *, mesh: Optional[Mesh] = None,
                 n_centroids: int = 0, router_iters: int = 10,
                 router_seed: int = 0, pooled=None,
                 corpus_format: str = "bf16", device="cuda") -> Corpus:
    """Build the corpus facade: with a ``mesh``, ``shard_corpus`` plus
    (``n_centroids > 0``) the centroid router built at shard time over the
    same contiguous blocks, on the mesh's devices; without one, the
    single-device corpus on ``device``.

    ``corpus_format`` ('bf16' | 'int8' | 'residual') selects the resident
    encoding: 'bf16' keeps the source dtype (bf16 stays bf16, anything else
    becomes f32); 'int8' and 'residual' are encoded on ``device`` chunk by
    chunk (``kernels.quant``), so the float corpus is never resident there
    whole. 'residual' needs centroids, so it bumps ``n_centroids`` to 8
    when none were requested: the router's centroids are its codebook.
    ``embs`` and ``mask`` are numpy-convertible or tensors."""
    if corpus_format not in CORPUS_FORMATS:
        raise ValueError(f"unknown corpus format {corpus_format!r}; "
                         f"expected one of {CORPUS_FORMATS}")
    if mesh is not None:
        sc = shard_corpus(embs, mask, mesh, pooled=pooled,
                          n_centroids=n_centroids, router_iters=router_iters,
                          router_seed=router_seed,
                          corpus_format=corpus_format)
        return Corpus(embs=sc.embs, mask=sc.mask, n_docs=sc.n_docs,
                      n_shards=sc.n_shards, docs_per_shard=sc.docs_per_shard,
                      valid_docs=sc.valid_docs, router=sc.router, fmt=sc.fmt,
                      mesh=mesh, pooled=sc.pooled)
    src = embs if isinstance(embs, torch.Tensor) else torch.as_tensor(
        np.asarray(embs))
    dmask = torch.as_tensor(_host(mask).astype(bool))
    if src.dim() != 3 or dmask.dim() != 2 \
            or tuple(src.shape[:2]) != tuple(dmask.shape):
        raise ValueError("corpus must be (C, L, M) embs + (C, L) mask")
    dev = torch.device(device)
    C = src.shape[0]
    if corpus_format == "residual" and not n_centroids:
        n_centroids = 8  # the residual codebook IS the router's centroids
    router = None
    if n_centroids:
        router = build_router(src, dmask, n_shards=1, docs_per_shard=C,
                              n_centroids=n_centroids, n_iters=router_iters,
                              seed=router_seed, device=dev)
    if corpus_format == "bf16":
        resident = src.to(dev, dtype=src.dtype if src.dtype == torch.bfloat16
                          else torch.float32)
    else:
        resident = quantize(src, corpus_format, device=dev,
                            codebook=None if router is None
                            else router.centroids)
    return Corpus(embs=resident, mask=dmask.to(dev), n_docs=C, n_shards=1,
                  docs_per_shard=C, valid_docs=np.asarray([C], np.int32),
                  router=router, fmt=corpus_format,
                  pooled=None if pooled is None else torch.as_tensor(
                      np.asarray(_host(pooled), np.float32), device=dev))
