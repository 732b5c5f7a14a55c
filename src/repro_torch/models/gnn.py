"""PNA — Principal Neighbourhood Aggregation [arXiv:2004.05718] (port of
``repro.models.gnn``).

Message passing is a scatter over an edge index (src -> dst): sums and
counts by ``index_add_``, max and min by ``scatter_reduce(..., "amax",
include_self=False)`` into a filled buffer, so a node no edge reaches keeps
the fill and is then zeroed where its degree is 0. Four aggregators (mean
/ max / min / std) x three degree scalers (identity, amplification,
attenuation), JAX's formulas: max and min come from ``-1e30`` fills of the
masked edges (min as minus the max of the negated messages), std is
``sqrt(max(E[x^2] - E[x]^2, 0) + 1e-8)``, the scalers use
``mean_log_deg = 2``, the residual is ``h + relu(upd)`` and logits are 0
outside ``node_mask``. Tied maxima share their gradient evenly and
``maximum(var, 0)`` splits it at 0, as JAX's rules do. On CUDA the
scatters add with atomics, so the card and the CPU agree within a
tolerance, not bit for bit.

``PNA`` holds ``encode`` (d_feat, d), the layers (``w_msg_src``,
``w_msg_dst`` (d, d), ``w_update`` (d (1 + n_agg), d)) and ``decode`` (d,
n_classes); JAX stacks the layers, this keeps them in a ``ModuleList``.
``pna_forward`` runs where the parameters live and moves the batch there.

The data helpers are numpy, JAX's code with the same ``rng`` calls in the
same order, so they give the same graphs: ``random_graph``,
block-diagonal ``batch_molecules``, ``build_csr``, the GraphSAGE-style
fanout sampler ``sample_subgraph`` (with replacement, static shapes,
self-loops for isolated nodes) and ``partition_edges_by_dst``. Their
``GraphBatch`` holds CPU tensors; ``GraphBatch.to`` places one.

``pna_loss_sharded`` is JAX's shard_map step over a ``dist.mesh.Mesh`` in
one process: edges partitioned by destination range, each shard
aggregating into its own node range, one all-gather (a shard-major
``torch.cat``) per layer rebuilding the replicated features, the loss a
sum over shards; autograd runs through the gathers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.models.layers import _param, dense_init

_BIG = 1e30


class GraphBatch(NamedTuple):
    feats: torch.Tensor      # (N, d_feat)
    senders: torch.Tensor    # (E,) int32
    receivers: torch.Tensor  # (E,) int32
    edge_mask: torch.Tensor  # (E,) bool
    node_mask: torch.Tensor  # (N,) bool
    labels: torch.Tensor     # (N,) int32

    def to(self, device) -> "GraphBatch":
        return GraphBatch(*(t.to(device) for t in self))


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class PNALayer(nn.Module):
    def __init__(self, d: int, n_agg: int, dtype=torch.float32,
                 device="cuda"):
        super().__init__()

        def empty(*shape):
            return _param(torch.empty(shape, dtype=dtype, device=device))
        self.w_msg_src = empty(d, d)
        self.w_msg_dst = empty(d, d)
        self.w_update = empty(d * (1 + n_agg), d)


class PNA(nn.Module):
    def __init__(self, cfg: GNNConfig, d_feat: int, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        n_agg = len(cfg.aggregators) * len(cfg.scalers)
        self.encode = _param(torch.empty((d_feat, cfg.d_hidden), dtype=dtype,
                                         device=device))
        self.layers = nn.ModuleList(
            PNALayer(cfg.d_hidden, n_agg, dtype, device)
            for _ in range(cfg.n_layers))
        self.decode = _param(torch.empty((cfg.d_hidden, cfg.n_classes),
                                         dtype=dtype, device=device))

    @property
    def device(self) -> torch.device:
        return self.encode.device


def init_pna(cfg: GNNConfig, d_feat: int, *, seed: int = 0,
             dtype=torch.float32, device="cuda",
             generator: Optional[torch.Generator] = None) -> PNA:
    """JAX's distributions (every weight N(0, 1/d_in)), drawn on ``device``
    from ``generator`` or a generator seeded with ``seed``, in JAX's key
    order: encode, decode, then each layer's three weights."""
    gen = generator
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(seed)
    p = PNA(cfg, d_feat, dtype, device)
    with torch.no_grad():
        ws = [p.encode, p.decode]
        for lp in p.layers:
            ws += [lp.w_msg_src, lp.w_msg_dst, lp.w_update]
        for w in ws:
            w.copy_(dense_init(gen, w.shape[0], w.shape[1], dtype, device))
    return p


def _segment_max(x: torch.Tensor, seg: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Per-segment max of rows of x; a segment no row reaches holds -BIG
    (zeroed by the caller where its degree is 0)."""
    out = torch.full((n, x.shape[1]), -_BIG, dtype=x.dtype, device=x.device)
    return out.scatter_reduce(0, seg[:, None].expand_as(x), x, "amax",
                              include_self=False)


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add(0, seg, x)


def _aggregate(msgs: torch.Tensor, receivers: torch.Tensor,
               edge_mask: torch.Tensor, n_nodes: int, aggregators
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment-reduce messages per destination node.
    Returns (concat aggregates (N, n_agg * d), degree (N,))."""
    seg = receivers.to(torch.int64)
    m = edge_mask[:, None]
    msgs_m = msgs * edge_mask.to(msgs.dtype)[:, None]
    deg = _segment_sum(edge_mask.to(torch.float32), seg, n_nodes)
    safe_deg = torch.clamp(deg, min=1.0)[:, None]
    has = deg[:, None] > 0

    outs = []
    mean = _segment_sum(msgs_m, seg, n_nodes) / safe_deg
    for agg in aggregators:
        if agg == "mean":
            outs.append(mean)
        elif agg == "max":
            mx = _segment_max(torch.where(m, msgs, -_BIG), seg, n_nodes)
            outs.append(torch.where(has, mx, 0.0))
        elif agg == "min":
            mn = -_segment_max(torch.where(m, -msgs, -_BIG), seg, n_nodes)
            outs.append(torch.where(has, mn, 0.0))
        elif agg == "std":
            sq = _segment_sum(msgs_m * msgs_m, seg, n_nodes)
            var = torch.maximum(sq / safe_deg - mean * mean,
                                torch.zeros((), dtype=mean.dtype,
                                            device=mean.device))
            outs.append(torch.sqrt(var + 1e-8))
        else:
            raise ValueError(agg)
    return torch.cat(outs, dim=-1), deg


def _scale(agg: torch.Tensor, deg: torch.Tensor, scalers,
           mean_log_deg: float) -> torch.Tensor:
    """PNA degree scalers applied to the concatenated aggregates."""
    logd = torch.log(deg + 1.0)[:, None]
    d_inv = mean_log_deg
    outs = []
    for s in scalers:
        if s == "identity":
            outs.append(agg)
        elif s == "amplification":
            outs.append(agg * (logd / d_inv))
        elif s == "attenuation":
            outs.append(agg * (d_inv / torch.clamp(logd, min=1e-3)))
        else:
            raise ValueError(s)
    return torch.cat(outs, dim=-1)


def _layer(lp: PNALayer, cfg: GNNConfig, h_src: torch.Tensor,
           h_loc: torch.Tensor, senders: torch.Tensor,
           receivers: torch.Tensor, local_recv: torch.Tensor,
           edge_mask: torch.Tensor, mean_log_deg: float) -> torch.Tensor:
    """One PNA layer: messages over the edges from the full features
    ``h_src``, aggregated into the node range of ``h_loc``."""
    msg = (h_src[senders.to(torch.int64)] @ lp.w_msg_src
           + h_src[receivers.to(torch.int64)] @ lp.w_msg_dst)
    msg = torch.relu(msg)
    agg, deg = _aggregate(msg, local_recv, edge_mask, h_loc.shape[0],
                          cfg.aggregators)
    scaled = _scale(agg, deg, cfg.scalers, mean_log_deg)
    upd = torch.cat([h_loc, scaled], dim=-1) @ lp.w_update
    return h_loc + torch.relu(upd)


def pna_forward(params: PNA, cfg: GNNConfig, batch: GraphBatch, *,
                mean_log_deg: float = 2.0) -> torch.Tensor:
    """Full PNA forward -> per-node class logits (N, n_classes)."""
    b = batch.to(params.device)
    h = b.feats @ params.encode
    for lp in params.layers:
        h = _layer(lp, cfg, h, h, b.senders, b.receivers, b.receivers,
                   b.edge_mask, mean_log_deg)
    logits = h @ params.decode
    return torch.where(b.node_mask[:, None], logits, 0.0)


def _nll(logits: torch.Tensor, labels: torch.Tensor,
         node_mask: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels.to(torch.int64)[:, None])[:, 0]
    return torch.where(node_mask, nll, 0.0)


def pna_loss(params: PNA, cfg: GNNConfig, batch: GraphBatch,
             **kw) -> torch.Tensor:
    b = batch.to(params.device)
    nll = _nll(pna_forward(params, cfg, b, **kw), b.labels, b.node_mask)
    return torch.sum(nll) / torch.clamp(
        torch.sum(b.node_mask.to(torch.float32)), min=1.0)


# ---------------------------------------------------------------------------
# data utilities (numpy, JAX's code)
# ---------------------------------------------------------------------------

def _batch(feats, send, recv, labels) -> GraphBatch:
    return GraphBatch(
        feats=torch.from_numpy(np.ascontiguousarray(feats)),
        senders=torch.from_numpy(send), receivers=torch.from_numpy(recv),
        edge_mask=torch.ones(send.shape[0], dtype=torch.bool),
        node_mask=torch.ones(feats.shape[0], dtype=torch.bool),
        labels=torch.from_numpy(labels))


def random_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int,
                 seed: int = 0) -> GraphBatch:
    rng = np.random.default_rng(seed)
    send = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    recv = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    feats = rng.standard_normal((n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    return _batch(feats, send, recv, labels)


def batch_molecules(n_graphs: int, nodes_per: int, edges_per: int,
                    d_feat: int, n_classes: int, seed: int = 0) -> GraphBatch:
    """Block-diagonal batching: one big disconnected graph, offsets per
    molecule."""
    gs = [random_graph(nodes_per, edges_per, d_feat, n_classes, seed + i)
          for i in range(n_graphs)]
    off = [np.int32(i * nodes_per) for i in range(n_graphs)]
    return _batch(
        np.concatenate([g.feats.numpy() for g in gs]),
        np.concatenate([g.senders.numpy() + o for g, o in zip(gs, off)]),
        np.concatenate([g.receivers.numpy() + o for g, o in zip(gs, off)]),
        np.concatenate([g.labels.numpy() for g in gs]))


class CSRGraph(NamedTuple):
    indptr: np.ndarray    # (N+1,)
    indices: np.ndarray   # (E,)


def build_csr(n_nodes: int, senders: np.ndarray,
              receivers: np.ndarray) -> CSRGraph:
    order = np.argsort(receivers, kind="stable")
    sorted_recv = receivers[order]
    sorted_send = senders[order]
    counts = np.bincount(sorted_recv, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr=indptr, indices=sorted_send.astype(np.int32))


def sample_subgraph(csr: CSRGraph, feats: np.ndarray, labels: np.ndarray,
                    seeds: np.ndarray, fanout: Tuple[int, ...],
                    seed: int = 0) -> GraphBatch:
    """GraphSAGE-style fanout sampling with static shapes (with
    replacement; zero-degree nodes get self-loops). Layer l expands the
    frontier by fanout[l]. Node order: [seeds, layer-1 samples, ...]."""
    rng = np.random.default_rng(seed)
    frontier = seeds.astype(np.int64)
    all_nodes = [frontier]
    send_list, recv_list = [], []
    offset = 0
    for f in fanout:
        deg = csr.indptr[frontier + 1] - csr.indptr[frontier]
        r = rng.integers(0, np.maximum(deg, 1)[:, None], (frontier.size, f))
        nbr = np.where(deg[:, None] > 0,
                       csr.indices[np.minimum(csr.indptr[frontier][:, None]
                                              + r, len(csr.indices) - 1)],
                       frontier[:, None])   # self-loop for isolated nodes
        new_offset = offset + frontier.size
        dst_local = np.repeat(np.arange(offset, new_offset), f)
        src_local = np.arange(new_offset, new_offset + nbr.size)
        send_list.append(src_local)
        recv_list.append(dst_local)
        frontier = nbr.reshape(-1)
        all_nodes.append(frontier)
        offset = new_offset

    nodes = np.concatenate(all_nodes)
    return _batch(np.asarray(feats)[nodes],
                  np.concatenate(send_list).astype(np.int32),
                  np.concatenate(recv_list).astype(np.int32),
                  np.asarray(labels)[nodes].astype(np.int32))


# ---------------------------------------------------------------------------
# distributed full-graph step (edge partition by destination)
# ---------------------------------------------------------------------------

def partition_edges_by_dst(senders: np.ndarray, receivers: np.ndarray,
                           n_nodes: int, n_parts: int
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shard d owns the node range [d N / n_parts, (d + 1) N / n_parts)
    and receives exactly the edges whose destination falls in it, padded
    to the largest part. Returns padded (senders, receivers, edge_mask) of
    shape (n_parts * per_part,)."""
    if n_nodes % n_parts:
        raise ValueError(f"{n_nodes} nodes do not split into {n_parts} "
                         "parts")
    rng_size = n_nodes // n_parts
    part = receivers // rng_size
    order = np.argsort(part, kind="stable")
    s_sorted, r_sorted, p_sorted = senders[order], receivers[order], \
        part[order]
    counts = np.bincount(p_sorted, minlength=n_parts)
    per_part = int(counts.max())
    S = np.zeros((n_parts, per_part), np.int32)
    R = np.zeros((n_parts, per_part), np.int32)
    M = np.zeros((n_parts, per_part), bool)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for d in range(n_parts):
        c = counts[d]
        S[d, :c] = s_sorted[starts[d]:starts[d] + c]
        R[d, :c] = r_sorted[starts[d]:starts[d] + c]
        M[d, :c] = True
        R[d, c:] = d * rng_size          # padding points in-range (masked)
    return S.reshape(-1), R.reshape(-1), M.reshape(-1)


def pna_loss_sharded(params: PNA, cfg: GNNConfig, batch: GraphBatch, mesh,
                     *, mean_log_deg: float = 2.0) -> torch.Tensor:
    """The loss of ``pna_loss`` with the edges partitioned over the mesh's
    shards (``partition_edges_by_dst``'s layout: shard d holds the d-th
    block of the edge arrays): each shard aggregates into its node range
    on its device, and one all-gather per layer rebuilds the replicated
    features. Returns the loss on ``mesh.devices[0]``."""
    n_dev = mesh.size
    n_nodes = batch.feats.shape[0]
    if n_nodes % n_dev or batch.senders.shape[0] % n_dev:
        raise ValueError(f"{n_nodes} nodes / {batch.senders.shape[0]} edges "
                         f"do not split over {n_dev} shards")
    n_loc = n_nodes // n_dev
    e_loc = batch.senders.shape[0] // n_dev
    home = mesh.devices[0]
    b = batch.to(params.device)
    h = b.feats @ params.encode

    def shard(d: int, x: torch.Tensor) -> torch.Tensor:
        return x[d * e_loc:(d + 1) * e_loc].to(mesh.devices[d])

    edges = [(shard(d, b.senders), shard(d, b.receivers),
              shard(d, b.edge_mask)) for d in range(n_dev)]
    for lp in params.layers:
        parts = []
        for d, (snd, rcv, msk) in enumerate(edges):
            base = d * n_loc
            h_d = h.to(mesh.devices[d])
            parts.append(_layer(lp, cfg, h_d, h_d[base:base + n_loc], snd,
                                rcv, rcv - base, msk, mean_log_deg))
        h = torch.cat([p.to(home) for p in parts])         # all_gather
    tot = cnt = None
    for d in range(n_dev):
        sl = slice(d * n_loc, (d + 1) * n_loc)
        logits = h[sl] @ params.decode
        nll = _nll(logits, b.labels[sl], b.node_mask[sl])
        t = torch.sum(nll)
        c = torch.sum(b.node_mask[sl].to(torch.float32))
        tot = t if tot is None else tot + t                 # psum
        cnt = c if cnt is None else cnt + c
    return tot / torch.clamp(cnt, min=1.0)
