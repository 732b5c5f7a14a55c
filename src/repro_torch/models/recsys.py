"""RecSys model zoo: FM, AutoInt, DIN, SASRec.

The counterpart of ``src/repro/models/recsys.py``, op for op. The hot path
is the sparse embedding lookup: all field tables live in ONE concatenated
(total_rows, dim) tensor with static per-field offsets, so a lookup is one
gather. ``embedding_bag`` is gather + segment reduce, as in JAX (an empty
bag gives 0 for "sum" and "mean" and -inf for "max", as
``jax.ops.segment_max``). An out-of-range id raises here, where JAX's
``take`` returns NaN; the chunked ``*_score_candidates`` pad the last chunk
with id 0, as JAX does, so their padded tail stays in range.

``*_score_candidates`` implement the retrieval_cand shape (1 query vs 10^6
items); ``fm_candidate_components`` exposes FM's sum-decomposable component
matrix to the generalized Col-Bandit (``core/generalized.py``). These
serving functions run under ``torch.no_grad``; the ``*_forward`` s are
also the training forwards (``train/train_step.py``).

The parameter holders are ``nn.Module`` s (``FM``, ``AutoInt``, ``DIN``,
``SASRec``); the functions keep JAX's names and take the module where JAX
takes a parameter dict. Each ``init_*`` draws JAX's distributions on
``device`` (``"cuda"`` unless the caller passes "cpu") from ``generator``
or a generator seeded with ``seed``; every function runs where the
parameters live.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import RecsysConfig
from repro_torch.models.layers import (Dense, _param, dense, fill_dense,
                                       layer_norm)


def _gen(device, seed: int,
         generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(seed)


def _normal(gen: torch.Generator, shape, scale: float, dtype,
            device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def _ids(params: nn.Module, ids) -> torch.Tensor:
    dev = next(params.parameters()).device
    return torch.as_tensor(ids, device=dev).to(torch.int64)


# ---------------------------------------------------------------------------
# EmbeddingBag substrate
# ---------------------------------------------------------------------------

def field_offsets(vocab_sizes: Sequence[int]) -> np.ndarray:
    """Static row offset of each field's sub-table in the fused table."""
    return np.concatenate([[0], np.cumsum(np.asarray(vocab_sizes))[:-1]])


def fused_rows(vocab_sizes: Sequence[int], pad_rows_to: int = 4096) -> int:
    """Rows of the fused table: the fields' rows, padded to a multiple of
    ``pad_rows_to`` (so the table row-shards over any mesh)."""
    total = int(np.sum(np.asarray(vocab_sizes)))
    return -(-total // pad_rows_to) * pad_rows_to


def init_fused_table(gen: torch.Generator, vocab_sizes: Sequence[int],
                     dim: int, dtype=torch.float32, device="cuda",
                     pad_rows_to: int = 4096) -> torch.Tensor:
    """(fused_rows, dim), N(0, 0.05^2)."""
    return _normal(gen, (fused_rows(vocab_sizes, pad_rows_to), dim), 0.05,
                   dtype, device)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     offsets: np.ndarray) -> torch.Tensor:
    """Single-hot per-field lookup. ids: (B, F) local per-field indices ->
    (B, F, dim)."""
    ids = torch.as_tensor(ids, device=table.device).to(torch.int64)
    global_ids = ids + torch.as_tensor(offsets, dtype=torch.int64,
                                       device=table.device)[None, :]
    return table[global_ids]


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  bag_ids: torch.Tensor, n_bags: int,
                  weights: Optional[torch.Tensor] = None,
                  mode: str = "sum") -> torch.Tensor:
    """Multi-hot EmbeddingBag: ids (nnz,) global rows, bag_ids (nnz,) ->
    (n_bags, dim) via gather + segment reduce."""
    if mode not in ("sum", "mean", "max"):
        raise ValueError(mode)
    dev = table.device
    ids = torch.as_tensor(ids, device=dev).to(torch.int64)
    bag_ids = torch.as_tensor(bag_ids, device=dev).to(torch.int64)
    rows = table[ids]                                        # (nnz, dim)
    if weights is not None:
        rows = rows * torch.as_tensor(weights, device=dev)[:, None]
    shape = (n_bags, rows.shape[-1])
    if mode == "max":
        out = torch.full(shape, -math.inf, dtype=rows.dtype, device=dev)
        return out.scatter_reduce_(0, bag_ids[:, None].expand_as(rows), rows,
                                   "amax", include_self=True)
    summed = torch.zeros(shape, dtype=rows.dtype, device=dev)
    summed.index_add_(0, bag_ids, rows)
    if mode == "sum":
        return summed
    cnt = torch.zeros((n_bags,), dtype=rows.dtype, device=dev)
    cnt.index_add_(0, bag_ids, torch.ones_like(bag_ids, dtype=rows.dtype))
    return summed / torch.clamp(cnt, min=1.0)[:, None]


def _chunked(score_chunk, cand_ids: torch.Tensor, chunk: int) -> torch.Tensor:
    """score_chunk over ``chunk`` candidates at a time; the last chunk is
    padded with id 0 and the padded scores dropped (JAX's ``lax.map``)."""
    n = cand_ids.shape[0]
    if n <= chunk:
        return score_chunk(cand_ids)
    n_chunks = -(-n // chunk)
    padded = torch.zeros((n_chunks * chunk,), dtype=cand_ids.dtype,
                         device=cand_ids.device)
    padded[:n] = cand_ids
    out = [score_chunk(c) for c in padded.reshape(n_chunks, chunk)]
    return torch.cat(out)[:n]


# ---------------------------------------------------------------------------
# FM  [Rendle ICDM'10]
# ---------------------------------------------------------------------------

class FM(nn.Module):
    """table (rows, D), linear (rows, 1), bias ()."""

    def __init__(self, cfg: RecsysConfig, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        rows = fused_rows(cfg.vocab_sizes)
        self.table = _param(torch.empty((rows, cfg.embed_dim), dtype=dtype,
                                        device=device))
        self.linear = _param(torch.empty((rows, 1), dtype=dtype,
                                         device=device))
        self.bias = _param(torch.zeros((), dtype=dtype, device=device))


def init_fm(cfg: RecsysConfig, *, seed: int = 0, dtype=torch.float32,
            device="cuda",
            generator: Optional[torch.Generator] = None) -> FM:
    gen = _gen(device, seed, generator)
    p = FM(cfg, dtype, device)
    with torch.no_grad():
        p.table.copy_(init_fused_table(gen, cfg.vocab_sizes, cfg.embed_dim,
                                       dtype, device))
        p.linear.copy_(init_fused_table(gen, cfg.vocab_sizes, 1, dtype,
                                        device))
    return p


def fm_forward(params: FM, cfg: RecsysConfig, ids) -> torch.Tensor:
    """ids (B, F) -> logit (B,). Pairwise term via the O(nk) sum-square
    trick: sum_{i<j} <v_i, v_j> = 0.5 * ((sum v)^2 - sum v^2)."""
    offs = field_offsets(cfg.vocab_sizes)
    ids = _ids(params, ids)
    v = embedding_lookup(params.table, ids, offs)            # (B, F, D)
    lin = embedding_lookup(params.linear, ids, offs)[..., 0]  # (B, F)
    s = v.sum(dim=1)                                         # (B, D)
    s2 = (v * v).sum(dim=1)                                  # (B, D)
    pair = 0.5 * (s * s - s2).sum(dim=-1)                    # (B,)
    return params.bias + lin.sum(dim=-1) + pair


def _fm_context(params: FM, cfg: RecsysConfig, context_ids, cand_ids
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(context rows (F-1, D), candidate rows (N, D), linear (N, 1))."""
    offs = field_offsets(cfg.vocab_sizes)
    ctx = embedding_lookup(params.table, _ids(params, context_ids)[None, :],
                           offs[:-1])[0]                     # (F-1, D)
    cand_rows = _ids(params, cand_ids) + int(offs[-1])
    return ctx, params.table[cand_rows], params.linear[cand_rows]


@torch.no_grad()
def fm_score_candidates(params: FM, cfg: RecsysConfig, context_ids,
                        cand_ids) -> torch.Tensor:
    """retrieval_cand: fixed context fields (F-1 ids), candidate fills the
    last field. score(i) = const + lin_i + <v_i, sum_f v_f> (FM algebra),
    O(N*D) instead of O(N*F*D); the constant is left out (rank-free)."""
    ctx, v_c, lin_c = _fm_context(params, cfg, context_ids, cand_ids)
    return lin_c[:, 0] + v_c @ ctx.sum(dim=0)


@torch.no_grad()
def fm_candidate_components(params: FM, cfg: RecsysConfig, context_ids,
                            cand_ids) -> torch.Tensor:
    """(N, F) component matrix for the generalized bandit: column f is the
    candidate x context-field-f interaction (+ linear term in col 0)."""
    ctx, v_c, lin_c = _fm_context(params, cfg, context_ids, cand_ids)
    return torch.cat([lin_c, v_c @ ctx.T], dim=-1)


# ---------------------------------------------------------------------------
# AutoInt  [arXiv:1810.11921]
# ---------------------------------------------------------------------------

class InteractingLayer(nn.Module):
    """wq, wk, wv, w_res (d_in, d_attn * n_heads), no biases."""

    def __init__(self, d_in: int, d_out: int, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        for name in ("wq", "wk", "wv", "w_res"):
            setattr(self, name, _param(torch.empty((d_in, d_out),
                                                   dtype=dtype,
                                                   device=device)))


class AutoInt(nn.Module):
    """table (rows, D), the interacting layers, out (F * d, 1)."""

    def __init__(self, cfg: RecsysConfig, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.table = _param(torch.empty(
            (fused_rows(cfg.vocab_sizes), cfg.embed_dim), dtype=dtype,
            device=device))
        d_in, d_out = cfg.embed_dim, cfg.d_attn * cfg.n_heads
        layers = []
        for _ in range(cfg.n_attn_layers):
            layers.append(InteractingLayer(d_in, d_out, dtype, device))
            d_in = d_out
        self.layers = nn.ModuleList(layers)
        self.out = Dense(d_in * cfg.n_sparse, 1, True, dtype, device)


def init_autoint(cfg: RecsysConfig, *, seed: int = 0, dtype=torch.float32,
                 device="cuda",
                 generator: Optional[torch.Generator] = None) -> AutoInt:
    gen = _gen(device, seed, generator)
    p = AutoInt(cfg, dtype, device)
    with torch.no_grad():
        p.table.copy_(init_fused_table(gen, cfg.vocab_sizes, cfg.embed_dim,
                                       dtype, device))
        for lp in p.layers:
            fill_dense(gen, lp.wq, lp.wk, lp.wv, lp.w_res)
        fill_dense(gen, p.out.w)
    return p


def _interacting_layer(p: InteractingLayer, x: torch.Tensor, n_heads: int,
                       d_attn: int) -> torch.Tensor:
    """Multi-head self-attention over the FIELD axis (B, F, d)."""
    B, F, _ = x.shape
    q = (x @ p.wq).reshape(B, F, n_heads, d_attn)
    k = (x @ p.wk).reshape(B, F, n_heads, d_attn)
    v = (x @ p.wv).reshape(B, F, n_heads, d_attn)
    logits = torch.einsum("bfhd,bghd->bhfg", q, k) / math.sqrt(d_attn)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhfg,bghd->bfhd", w, v).reshape(B, F,
                                                        n_heads * d_attn)
    return torch.relu(out + x @ p.w_res)


def autoint_forward(params: AutoInt, cfg: RecsysConfig,
                    ids) -> torch.Tensor:
    offs = field_offsets(cfg.vocab_sizes)
    x = embedding_lookup(params.table, _ids(params, ids), offs)  # (B, F, D)
    for lp in params.layers:
        x = _interacting_layer(lp, x, cfg.n_heads, cfg.d_attn)
    return dense(params.out, x.reshape(x.shape[0], -1))[:, 0]


@torch.no_grad()
def autoint_score_candidates(params: AutoInt, cfg: RecsysConfig,
                             context_ids, cand_ids,
                             chunk: int = 8192) -> torch.Tensor:
    """Score N candidates sharing fixed context fields: full forward with the
    candidate substituted into the last field, chunked over candidates."""
    context_ids = _ids(params, context_ids)

    def score_chunk(c_ids):
        ids = torch.cat([context_ids[None, :].expand(c_ids.shape[0], -1),
                         c_ids[:, None]], dim=-1)
        return autoint_forward(params, cfg, ids)

    return _chunked(score_chunk, _ids(params, cand_ids), chunk)


# ---------------------------------------------------------------------------
# DIN  [arXiv:1706.06978]
# ---------------------------------------------------------------------------

class DIN(nn.Module):
    """item_table (items, D), the attention MLP (4D -> ... -> 1) and the
    main MLP (3D -> ... -> 1), each a list of ``Dense``."""

    def __init__(self, cfg: RecsysConfig, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        d = cfg.embed_dim
        self.item_table = _param(torch.empty((cfg.item_vocab, d),
                                             dtype=dtype, device=device))
        dims = (4 * d, cfg.attn_mlp[0], cfg.attn_mlp[1], 1)
        self.attn = nn.ModuleList(Dense(a, b, True, dtype, device)
                                  for a, b in zip(dims, dims[1:]))
        dims = (3 * d, cfg.mlp[0], cfg.mlp[1], 1)
        self.mlp = nn.ModuleList(Dense(a, b, True, dtype, device)
                                 for a, b in zip(dims, dims[1:]))


def init_din(cfg: RecsysConfig, *, seed: int = 0, dtype=torch.float32,
             device="cuda",
             generator: Optional[torch.Generator] = None) -> DIN:
    gen = _gen(device, seed, generator)
    p = DIN(cfg, dtype, device)
    with torch.no_grad():
        p.item_table.copy_(_normal(gen, p.item_table.shape, 0.05, dtype,
                                   device))
        fill_dense(gen, *(lp.w for lp in p.attn), *(lp.w for lp in p.mlp))
    return p


def _mlp_stack(layers: nn.ModuleList, z: torch.Tensor) -> torch.Tensor:
    """Dense layers with a sigmoid between them (none after the last)."""
    for i, lp in enumerate(layers):
        z = dense(lp, z)
        if i < len(layers) - 1:
            z = torch.sigmoid(z)
    return z


def _din_attention(p: DIN, hist: torch.Tensor, hist_mask: torch.Tensor,
                   target: torch.Tensor) -> torch.Tensor:
    """Target attention: weight each history item by MLP(h, t, h-t, h*t).
    hist (B, S, D), target (B, D) -> user interest vector (B, D)."""
    t = target[:, None, :].expand_as(hist)
    z = torch.cat([hist, t, hist - t, hist * t], dim=-1)
    w = _mlp_stack(p.attn, z)[..., 0]                       # (B, S) raw
    w = torch.where(hist_mask, w, 0.0)
    return torch.einsum("bs,bsd->bd", w, hist)


def din_forward(params: DIN, cfg: RecsysConfig, hist_ids, hist_mask,
                target_ids) -> torch.Tensor:
    dev = params.item_table.device
    hist = params.item_table[_ids(params, hist_ids)]         # (B, S, D)
    target = params.item_table[_ids(params, target_ids)]
    user = _din_attention(params, hist,
                          torch.as_tensor(hist_mask, device=dev), target)
    z = torch.cat([user, target, user * target], dim=-1)
    return _mlp_stack(params.mlp, z)[:, 0]


@torch.no_grad()
def din_score_candidates(params: DIN, cfg: RecsysConfig, hist_ids,
                         hist_mask, cand_ids,
                         chunk: int = 8192) -> torch.Tensor:
    """One user (hist (S,)) vs N candidate items."""
    hist_ids = _ids(params, hist_ids)
    hist_mask = torch.as_tensor(hist_mask, device=hist_ids.device)

    def score_chunk(c_ids):
        B = c_ids.shape[0]
        return din_forward(params, cfg, hist_ids[None].expand(B, -1),
                           hist_mask[None].expand(B, -1), c_ids)

    return _chunked(score_chunk, _ids(params, cand_ids), chunk)


# ---------------------------------------------------------------------------
# SASRec  [arXiv:1808.09781]
# ---------------------------------------------------------------------------

class SASRecBlock(nn.Module):
    """wq, wk, wv (D, D), ff1 / ff2 ``Dense`` (D, D), two layer norms."""

    def __init__(self, d: int, dtype=torch.float32, device="cuda"):
        super().__init__()
        for name in ("wq", "wk", "wv"):
            setattr(self, name, _param(torch.empty((d, d), dtype=dtype,
                                                   device=device)))
        self.ff1 = Dense(d, d, True, dtype, device)
        self.ff2 = Dense(d, d, True, dtype, device)
        for name in ("ln1", "ln2"):
            setattr(self, f"{name}_s", _param(torch.ones(
                (d,), dtype=dtype, device=device)))
            setattr(self, f"{name}_b", _param(torch.zeros(
                (d,), dtype=dtype, device=device)))


class SASRec(nn.Module):
    """item_table (items, D), pos_table (seq_len, D), the blocks."""

    def __init__(self, cfg: RecsysConfig, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        d = cfg.embed_dim
        self.item_table = _param(torch.empty((cfg.item_vocab, d),
                                             dtype=dtype, device=device))
        self.pos_table = _param(torch.empty((cfg.seq_len, d), dtype=dtype,
                                            device=device))
        self.blocks = nn.ModuleList(SASRecBlock(d, dtype, device)
                                    for _ in range(cfg.n_blocks))


def init_sasrec(cfg: RecsysConfig, *, seed: int = 0, dtype=torch.float32,
                device="cuda",
                generator: Optional[torch.Generator] = None) -> SASRec:
    gen = _gen(device, seed, generator)
    p = SASRec(cfg, dtype, device)
    with torch.no_grad():
        p.item_table.copy_(_normal(gen, p.item_table.shape, 0.05, dtype,
                                   device))
        p.pos_table.copy_(_normal(gen, p.pos_table.shape, 0.05, dtype,
                                  device))
        for bp in p.blocks:
            fill_dense(gen, bp.wq, bp.wk, bp.wv, bp.ff1.w, bp.ff2.w)
    return p


def sasrec_user_state(params: SASRec, cfg: RecsysConfig, hist_ids,
                      hist_mask) -> torch.Tensor:
    """hist (B, S) -> user representation (B, D): last valid position state
    after causal self-attention blocks."""
    hist_ids = _ids(params, hist_ids)
    hist_mask = torch.as_tensor(hist_mask, device=hist_ids.device)
    B, S = hist_ids.shape
    d = cfg.embed_dim
    x = params.item_table[hist_ids] + params.pos_table[None, :S]
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                   device=x.device))
    allowed = causal[None] & hist_mask[:, None, :]
    for bp in params.blocks:
        h = layer_norm(x, bp.ln1_s, bp.ln1_b)
        q, k, v = h @ bp.wq, h @ bp.wk, h @ bp.wv
        logits = torch.einsum("bsd,btd->bst", q, k) / math.sqrt(d)
        logits = torch.where(allowed, logits, -1e30)
        w = torch.softmax(logits, dim=-1)
        x = x + torch.einsum("bst,btd->bsd", w, v)
        h2 = layer_norm(x, bp.ln2_s, bp.ln2_b)
        x = x + dense(bp.ff2, torch.relu(dense(bp.ff1, h2)))
    # state at the last valid position
    last = torch.clamp(hist_mask.to(torch.int64).sum(dim=-1) - 1, min=0)
    return x[torch.arange(B, device=x.device), last]


def sasrec_forward(params: SASRec, cfg: RecsysConfig, hist_ids, hist_mask,
                   target_ids) -> torch.Tensor:
    """Next-item logit: <user_state, item_emb[target]>."""
    u = sasrec_user_state(params, cfg, hist_ids, hist_mask)
    t = params.item_table[_ids(params, target_ids)]
    return (u * t).sum(dim=-1)


@torch.no_grad()
def sasrec_score_candidates(params: SASRec, cfg: RecsysConfig, hist_ids,
                            hist_mask, cand_ids) -> torch.Tensor:
    """1 user vs N candidates: one user-state pass + (N, D) @ (D,) matvec."""
    hist_ids = _ids(params, hist_ids)
    hist_mask = torch.as_tensor(hist_mask, device=hist_ids.device)
    u = sasrec_user_state(params, cfg, hist_ids[None], hist_mask[None])[0]
    return params.item_table[_ids(params, cand_ids)] @ u
