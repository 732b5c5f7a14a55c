"""Configurable decoder LM: the backbones of the JAX package.

The counterpart of ``src/repro/models/transformer.py``, driven by
``LMConfig``:

  * GQA with arbitrary (n_heads, n_kv_heads)   -- every arch
  * sliding-window attention on every layer     -- mixtral, ``sliding_window``
  * local/global alternating layers + softcaps  -- gemma2
  * QKV bias                                    -- qwen2.5
  * routed MoE FFN (capacity dispatch)          -- mixtral, moonshot

JAX stacks the layers and runs them with ``lax.scan``; here a
``DecoderLM`` holds them in a ``ModuleList`` in execution order and Python
loops over them. JAX's ``models/scan_util.py`` (the scan's unroll flag, so
that XLA's cost analysis sees every layer) has no counterpart: an eager
loop is counted once per trip. gemma2 keeps JAX's pairing: blocks 2i and 2i + 1 are pair i's
local and global layer, whose K/V live in the "local" (ring, size window)
and "global" (full) cache stacks at index i. A MoE block (``cfg.moe``)
holds ``moe`` in place of ``mlp``: the train, hidden and prefill forwards
route with ``cfg.moe_capacity_factor`` (tokens beyond capacity dropped),
decode with ``no_drop=True``, as in JAX. ``remat=True`` recomputes the
forward in the backward (``torch.utils.checkpoint``, non-reentrant):
``forward_train`` checkpoints each layer (each local/global pair for
gemma2), ``forward_hidden`` nests the checkpoints sqrt(L)-style as JAX
does; the values and gradients are the same bit for bit. When
``dist.flash_decode.enabled()``, ``forward_decode`` attends through split-K
decode over the sequence-sharded cache (``flash_decode_attention``), as
JAX's decode does; otherwise it is unchanged.

Every entry point runs where the model's parameters live (``init_lm``
builds them on ``device="cuda"`` unless the caller passes "cpu"); token
ids are moved there, and nothing falls back to the CPU.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.dist import flash_decode as FD
from repro_torch.dist.mesh import Blocks, Mesh
from repro_torch.models import kv_cache as KV
from repro_torch.models.layers import (MLP, Attention, _param, apply_rope,
                                       attention, dense_init, embed_init,
                                       fill_dense, mlp, rms_norm, softcap)
from repro_torch.models.moe import MoE, fill_moe, moe_ffn

Position = KV.Position


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One pre-norm decoder layer: ln1, attn, ln2, and mlp or (``cfg.moe``)
    moe; the other one is None."""

    def __init__(self, cfg: LMConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.ln1 = _param(torch.zeros((cfg.d_model,), dtype=dtype,
                                      device=device))
        self.ln2 = _param(torch.zeros((cfg.d_model,), dtype=dtype,
                                      device=device))
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.d_head, cfg.qkv_bias, dtype, device)
        self.mlp = self.moe = None
        if cfg.moe:
            self.moe = MoE(cfg.d_model, cfg.moe_d_ff or cfg.d_ff,
                           cfg.n_experts, dtype, device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device)


class DecoderLM(nn.Module):
    """embed (V, D), final_norm (D,), head (D, V) (untied, as in JAX) and
    the blocks in execution order. Parameters are uninitialized: build one
    with ``init_lm`` or ``convert.lm_from_jax``."""

    def __init__(self, cfg: LMConfig, dtype=torch.float32, device="cuda"):
        super().__init__()
        if cfg.local_global_alternating and cfg.n_layers % 2:
            raise ValueError(f"{cfg.name}: local/global alternation needs "
                             f"an even n_layers, got {cfg.n_layers}")
        self.cfg = cfg
        self.embed = _param(torch.empty((cfg.vocab, cfg.d_model),
                                        dtype=dtype, device=device))
        self.final_norm = _param(torch.zeros((cfg.d_model,), dtype=dtype,
                                             device=device))
        self.head = _param(torch.empty((cfg.d_model, cfg.vocab),
                                       dtype=dtype, device=device))
        self.blocks = nn.ModuleList(Block(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_lm(cfg: LMConfig, *, seed: int = 0, dtype=torch.float32,
            device="cuda",
            generator: Optional[torch.Generator] = None) -> DecoderLM:
    """A ``DecoderLM`` with JAX's initial distributions (embeddings N(0,
    0.02), projections, routers and experts N(0, 1/d_in), norms and biases
    0), drawn on
    ``device`` from ``generator`` or a generator seeded with ``seed``."""
    gen = generator
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(seed)
    model = DecoderLM(cfg, dtype, device)
    with torch.no_grad():
        model.embed.copy_(embed_init(gen, cfg.vocab, cfg.d_model, dtype,
                                     device))
        model.head.copy_(dense_init(gen, cfg.d_model, cfg.vocab, dtype,
                                    device))
        for blk in model.blocks:
            fill_dense(gen, blk.attn.wq, blk.attn.wk, blk.attn.wv,
                       blk.attn.wo)
            if blk.moe is not None:
                fill_moe(gen, blk.moe)
            else:
                fill_dense(gen, blk.mlp.w_gate, blk.mlp.w_up, blk.mlp.w_down)
    return model


def cache_spec(cfg: LMConfig, max_seq: int) -> Dict[str, Tuple[int, int]]:
    """stack name -> (n_layers_in_stack, s_cache)."""
    w = cfg.sliding_window or 0
    if cfg.local_global_alternating:
        n_pairs = cfg.n_layers // 2
        return {"local": (n_pairs, min(w, max_seq) if w else max_seq),
                "global": (n_pairs, max_seq)}
    s = min(w, max_seq) if w else max_seq
    return {"all": (cfg.n_layers, s)}


def init_cache(cfg: LMConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cuda",
               mesh: Optional[Mesh] = None) -> KV.Cache:
    """An empty cache on ``device``, or with ``mesh`` every stack placed
    on it (``KV.init_stack``): each stack's slots must split over the
    ``model`` shards, a ring stack's window included."""
    out = {}
    for name, (n, s) in cache_spec(cfg, max_seq).items():
        try:
            out[name] = KV.init_stack(n, batch, s, cfg.n_kv_heads,
                                      cfg.d_head, dtype, device, mesh)
        except ValueError as e:
            raise ValueError(f"{cfg.name}: the {name!r} cache ({batch} x "
                             f"{s} slots): {e}") from None
    return out


def _window_scalar(cfg: LMConfig, local: bool) -> int:
    if local and cfg.sliding_window:
        return int(cfg.sliding_window)
    if (not cfg.local_global_alternating) and cfg.sliding_window:
        return int(cfg.sliding_window)
    return 0


def _plan(params: DecoderLM, cfg: LMConfig
          ) -> Iterator[Tuple[Block, str, int, int]]:
    """(block, cache stack, index in the stack, window) in execution
    order: JAX's scan over "all", or over the (local, global) pairs."""
    for i, blk in enumerate(params.blocks):
        if cfg.local_global_alternating:
            if i % 2 == 0:
                yield blk, "local", i // 2, _window_scalar(cfg, True)
            else:
                yield blk, "global", i // 2, 0
        else:
            yield blk, "all", i, _window_scalar(cfg, True)


def _token_ids(params: DecoderLM, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params.device).to(torch.int64)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


# ---------------------------------------------------------------------------
# layer body
# ---------------------------------------------------------------------------

def _layer(p: Block, x: torch.Tensor, positions: torch.Tensor,
           cfg: LMConfig, window: int, kv_override=None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pre-norm block. Returns (x_out, k_seq, v_seq), K/V exposed so that
    prefill can populate caches without recomputation."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    B, S, _ = h.shape
    k_seq = h @ p.attn.wk
    v_seq = h @ p.attn.wv
    if p.attn.bk is not None:
        k_seq = k_seq + p.attn.bk
        v_seq = v_seq + p.attn.bv
    k_seq = k_seq.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    v_seq = v_seq.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    k_rope = apply_rope(k_seq, positions, cfg.rope_theta)

    if kv_override is None:
        kv = (k_rope, v_seq, positions,
              torch.ones(positions.shape, dtype=torch.bool,
                         device=positions.device))
    else:
        kv = kv_override
    attn_out = attention(
        p.attn, h, positions, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
        rope_theta=cfg.rope_theta, window=window,
        attn_softcap=cfg.attn_softcap, kv_override=kv,
        q_chunk=cfg.attn_q_chunk)
    x = x + attn_out
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    return x + _ffn(p, h2, cfg), k_rope, v_seq


def _ffn(p: Block, h: torch.Tensor, cfg: LMConfig,
         no_drop: bool = False) -> torch.Tensor:
    if cfg.moe:
        return moe_ffn(p.moe, h, top_k=cfg.experts_top_k, act=cfg.act,
                       capacity_factor=cfg.moe_capacity_factor,
                       no_drop=no_drop)
    return mlp(p.mlp, h, act=cfg.act)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _units(params: DecoderLM, cfg: LMConfig) -> List[List[Tuple[Block, int]]]:
    """The stack JAX scans over, in execution order: one (block, window)
    per layer, or gemma2's (local, global) pairs."""
    plan = [(blk, window) for blk, _, _, window in _plan(params, cfg)]
    n = 2 if cfg.local_global_alternating else 1
    return [plan[i:i + n] for i in range(0, len(plan), n)]


def _run(x: torch.Tensor, units, positions: torch.Tensor, cfg: LMConfig,
         remat: bool) -> torch.Tensor:
    """The units in order, each under its own checkpoint when ``remat``."""
    for unit in units:
        if remat:
            x = checkpoint(_run, x, [unit], positions, cfg, False,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            for blk, window in unit:
                x, _, _ = _layer(blk, x, positions, cfg, window)
    return x


def _embed(params: DecoderLM, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
    tokens = _token_ids(params, tokens)
    B, S = tokens.shape
    return params.embed[tokens], _positions(B, S, tokens.device)


def forward_hidden(params: DecoderLM, cfg: LMConfig, tokens, *,
                   remat: bool = False) -> torch.Tensor:
    """tokens (B, S) -> final hidden states (B, S, D) (no LM head): the
    trunk of LM training (the head applied chunked in ``train_step``) and
    of the ColBERT late-interaction encoder. ``remat=True`` nests the
    checkpoints (JAX's sqrt-L scheme): the n units of the stack are cut
    into f outer blocks of n / f, f the largest divisor with f * f <= n;
    each block is checkpointed and holds a checkpointed loop over its
    units, so the backward keeps f + n / f carries, not n."""
    x, positions = _embed(params, tokens)
    units = _units(params, cfg)
    remat = remat and torch.is_grad_enabled()
    n = len(units)
    f = max((d for d in range(1, n + 1) if n % d == 0 and d * d <= n),
            default=1)
    if remat and f > 1:
        per = n // f
        for b in range(f):
            x = checkpoint(_run, x, units[b * per:(b + 1) * per], positions,
                           cfg, True, use_reentrant=False,
                           preserve_rng_state=False)
    else:
        x = _run(x, units, positions, cfg, remat)
    return rms_norm(x, params.final_norm, cfg.norm_eps)


def forward_train(params: DecoderLM, cfg: LMConfig, tokens, *,
                  remat: bool = True) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V). Full causal (+window) attention;
    ``remat=True`` checkpoints each layer (each gemma2 pair)."""
    x, positions = _embed(params, tokens)
    x = _run(x, _units(params, cfg), positions, cfg,
             remat and torch.is_grad_enabled())
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return softcap(x @ params.head, cfg.logit_softcap)


def forward_prefill(params: DecoderLM, cfg: LMConfig, tokens, max_seq: int,
                    cache_dtype=torch.bfloat16, mesh: Optional[Mesh] = None
                    ) -> Tuple[torch.Tensor, KV.Cache]:
    """Prefill: returns (last-token logits (B, V), populated cache). With
    ``mesh`` the cache is placed on it (``init_cache``) and each layer's
    K/V go into the blocks; the prefill itself runs where the parameters
    live."""
    tokens = _token_ids(params, tokens)
    B, S = tokens.shape
    x = params.embed[tokens]
    positions = _positions(B, S, tokens.device)
    spec = cache_spec(cfg, max_seq)
    cache = init_cache(cfg, B, max_seq, cache_dtype, tokens.device, mesh)
    for blk, stack, idx, window in _plan(params, cfg):
        x, k_seq, v_seq = _layer(blk, x, positions, cfg, window)
        k, v, pos = KV.prefill_write(k_seq.to(cache_dtype),
                                     v_seq.to(cache_dtype), positions,
                                     spec[stack][1])
        cache[stack].k[idx] = k     # placed: into every stored block
        cache[stack].v[idx] = v
        if idx == 0:  # every layer of a stack writes the same positions
            cache[stack].pos.copy_(pos)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = x[:, -1] @ params.head
    return softcap(logits, cfg.logit_softcap), cache


def forward_decode(params: DecoderLM, cfg: LMConfig, token,
                   position: Position, cache: KV.Cache
                   ) -> Tuple[torch.Tensor, KV.Cache]:
    """One decode step. token (B,) at ``position`` (an int or a 0-d int
    tensor, the same for the batch); returns (logits (B, V), the cache,
    updated in place). A placed cache (``init_cache(..., mesh=...)``) takes
    each write in the blocks that own the slot; split-K attends over the
    blocks on their devices, and without split-K the blocks are gathered to
    the parameters' device (``Blocks.gather``, an all-gather)."""
    token = _token_ids(params, token)
    B = token.shape[0]
    x = params.embed[token][:, None, :]                       # (B, 1, D)
    placed = isinstance(next(iter(cache.values())).k, Blocks)
    # a placed cache's owning blocks are chosen on the host (a tensor
    # position is read once a step)
    write_at = int(position) if placed else None
    position = KV.position_tensor(position, token.device)     # once a step
    positions = position.to(torch.int32).reshape(1, 1).expand(B, 1)
    for blk, stack, idx, window in _plan(params, cfg):
        st = cache[stack]
        k_l, v_l = st.k[idx], st.v[idx]                       # views
        h = rms_norm(x, blk.ln1, cfg.norm_eps)
        k_new = h @ blk.attn.wk
        v_new = h @ blk.attn.wv
        if blk.attn.bk is not None:
            k_new = k_new + blk.attn.bk
            v_new = v_new + blk.attn.bv
        k_new = k_new.reshape(B, 1, cfg.n_kv_heads, cfg.d_head)
        v_new = v_new.reshape(B, 1, cfg.n_kv_heads, cfg.d_head)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
        k_upd, v_upd, pos_upd = KV.write_token(
            k_l, v_l, st.pos, k_new.to(k_l.dtype), v_new.to(v_l.dtype),
            write_at if placed else position)
        if placed and not FD.enabled():     # GSPMD's all-gather of the cache
            k_upd, v_upd, pos_upd = (k_upd.gather(), v_upd.gather(),
                                     pos_upd.gather())
        # a placed cache's validity is taken per block, on its device
        kv_valid = None if placed and FD.enabled() else pos_upd >= 0
        if FD.enabled():
            # split-K attention over the sequence-sharded cache
            q = h @ blk.attn.wq
            if blk.attn.bq is not None:
                q = q + blk.attn.bq
            q = q.reshape(B, 1, cfg.n_heads, cfg.d_head)
            q = apply_rope(q, positions, cfg.rope_theta)
            qg = q.reshape(B, 1, cfg.n_kv_heads,
                           cfg.n_heads // cfg.n_kv_heads, cfg.d_head)
            o = FD.flash_decode_attention(
                qg, k_upd, v_upd, pos_upd, kv_valid, positions, window,
                1.0 / float(cfg.d_head) ** 0.5, cfg.attn_softcap)
            attn_out = (o.reshape(B, 1, cfg.n_heads * cfg.d_head)
                        .to(x.dtype) @ blk.attn.wo)
        else:
            attn_out = attention(
                blk.attn, h, positions, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
                rope_theta=cfg.rope_theta, window=window,
                attn_softcap=cfg.attn_softcap,
                kv_override=(k_upd, v_upd, pos_upd, kv_valid))
        x = x + attn_out
        h2 = rms_norm(x, blk.ln2, cfg.norm_eps)
        # decode never drops a token (worst-case capacity is cheap at S=1)
        x = x + _ffn(blk, h2, cfg, no_drop=True)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = x[:, 0] @ params.head
    return softcap(logits, cfg.logit_softcap), cache
