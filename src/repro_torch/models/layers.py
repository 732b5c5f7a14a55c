"""Shared neural building blocks of the LM backbones, in plain PyTorch.

The counterpart of ``src/repro/models/layers.py``: GQA, sliding-window,
local/global + softcaps, QKV bias. The JAX package computes all of it in
``jnp`` outside any Pallas kernel, so it is plain PyTorch here too, and
mirrors the JAX math op for op: weights keep JAX's (d_in, d_out) layout and
are applied as ``x @ w``, norms and RoPE run in float32, attention logits
are float32 with the softcap applied before the mask and masked logits
filled with -1e30 (``scaled_dot_product_attention`` has no softcap and
builds neither that fill nor the mask from positions).

The parameter holders are ``nn.Module`` s (``Attention``, ``MLP``,
``Dense``); the functions keep JAX's names and take the module where JAX
takes a parameter dict. Parameters are made with ``requires_grad=False``,
so a forward builds no autograd graph unless a train step
(``repro_torch.train.train_step``) turns gradients on for its own call.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_NEG = -1e30


def _param(t: torch.Tensor) -> nn.Parameter:
    """A parameter that takes no gradient until a train step asks for
    one (``train.train_step.trainable``)."""
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """N(0, 1) / sqrt(d_in), drawn in float32 from ``gen`` (JAX's
    distribution; a torch generator gives other numbers than a JAX key)."""
    scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def fill_dense(gen: torch.Generator, *weights: torch.Tensor) -> None:
    """``dense_init`` into each (d_in, d_out) weight, in order, in place."""
    for w in weights:
        w.copy_(dense_init(gen, w.shape[0], w.shape[1], w.dtype, w.device))


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps))
            * (1.0 + scale.to(torch.float32))).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(x, approximate="tanh")


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu,
            "dice": torch.sigmoid}[name]


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S). Rotate-half
    on the split halves (not interleaved), angles in float32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)             # (D/2,)
    ang = positions[..., None].to(torch.float32) * freqs      # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """Q/K/V/O projections (d_in, d_out), with optional Q/K/V biases."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 d_head: int, qkv_bias: bool, dtype=torch.float32,
                 device=None):
        super().__init__()

        def empty(*shape):
            return _param(torch.empty(shape, dtype=dtype, device=device))

        def zeros(n):
            return _param(torch.zeros((n,), dtype=dtype, device=device))
        self.wq = empty(d_model, n_heads * d_head)
        self.wk = empty(d_model, n_kv_heads * d_head)
        self.wv = empty(d_model, n_kv_heads * d_head)
        self.wo = empty(n_heads * d_head, d_model)
        self.bq = self.bk = self.bv = None
        if qkv_bias:
            self.bq = zeros(n_heads * d_head)
            self.bk = zeros(n_kv_heads * d_head)
            self.bv = zeros(n_kv_heads * d_head)


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, d_head: int, qkv_bias: bool,
                   dtype=torch.float32, device=None) -> Attention:
    p = Attention(d_model, n_heads, n_kv_heads, d_head, qkv_bias, dtype,
                  device)
    with torch.no_grad():
        fill_dense(gen, p.wq, p.wk, p.wv, p.wo)
    return p


def _attn_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor,
               window: int) -> torch.Tensor:
    """Causal + optional sliding window, built from positions.
    q_pos: (B, Sq); kv_pos: (B, Skv); window: <= 0 => full causal."""
    causal = kv_pos[:, None, :] <= q_pos[:, :, None]          # (B, Sq, Skv)
    if window > 0:
        dist = q_pos[:, :, None] - kv_pos[:, None, :]
        return causal & (dist < window)
    return causal


def attention(
    p: Attention,
    x: torch.Tensor,                # (B, S, D)
    positions: torch.Tensor,        # (B, S)
    *,
    n_heads: int,
    n_kv_heads: int,
    d_head: int,
    rope_theta: float,
    window: int,                    # <= 0 => full
    attn_softcap: Optional[float] = None,
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]] = None,
    q_chunk: int = 0,
) -> torch.Tensor:
    """Causal (optionally windowed) GQA self-attention.

    kv_override = (k, v, kv_pos, kv_valid) lets the decode path attend over
    a cache instead of the in-sequence K/V; shapes (B, Skv, Hkv, Dh),
    (B, Skv). q_chunk > 0 processes queries in sequential chunks, so the
    (S, Skv) logits never materialize whole."""
    B, S, _ = x.shape
    q = x @ p.wq
    if p.bq is not None:
        q = q + p.bq
    q = q.reshape(B, S, n_heads, d_head)
    q = apply_rope(q, positions, rope_theta)

    if kv_override is None:
        k = x @ p.wk
        v = x @ p.wv
        if p.bk is not None:
            k, v = k + p.bk, v + p.bv
        k = apply_rope(k.reshape(B, S, n_kv_heads, d_head), positions,
                       rope_theta)
        v = v.reshape(B, S, n_kv_heads, d_head)
        kv_pos = positions
        kv_valid = torch.ones((B, S), dtype=torch.bool, device=x.device)
    else:
        k, v, kv_pos, kv_valid = kv_override

    groups = n_heads // n_kv_heads
    # 1 / sqrt(d_head) rounded in float32, as JAX computes it.
    scale = 1.0 / torch.sqrt(torch.tensor(float(d_head), dtype=torch.float32,
                                          device=x.device))
    kf, vf = k.to(torch.float32), v.to(torch.float32)

    def attend(q_blk: torch.Tensor, pos_blk: torch.Tensor) -> torch.Tensor:
        """q_blk (B, Sq, H, Dh), pos_blk (B, Sq) -> (B, Sq, H*Dh)."""
        Sq = q_blk.shape[1]
        qg = q_blk.reshape(B, Sq, n_kv_heads, groups, d_head)
        logits = torch.einsum("bskgd,btkd->bkgst", qg.to(torch.float32),
                              kf) * scale
        logits = softcap(logits, attn_softcap)
        mask = _attn_mask(pos_blk, kv_pos, window) & kv_valid[:, None, :]
        logits = torch.where(mask[:, None, None, :, :], logits, _NEG)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgst,btkd->bskgd", w, vf)
        return out.reshape(B, Sq, n_heads * d_head).to(x.dtype)

    if q_chunk and S > q_chunk and S % q_chunk == 0:
        out = torch.cat([attend(q[:, c:c + q_chunk],
                                positions[:, c:c + q_chunk])
                         for c in range(0, S, q_chunk)], dim=1)
    else:
        out = attend(q, positions)
    return out @ p.wo


# ---------------------------------------------------------------------------
# MLP (GLU family) and a dense layer
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """Gated MLP weights: w_gate, w_up (d_model, d_ff), w_down (d_ff,
    d_model)."""

    def __init__(self, d_model: int, d_ff: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.w_gate = _param(torch.empty((d_model, d_ff), dtype=dtype,
                                         device=device))
        self.w_up = _param(torch.empty((d_model, d_ff), dtype=dtype,
                                       device=device))
        self.w_down = _param(torch.empty((d_ff, d_model), dtype=dtype,
                                         device=device))


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32, device=None) -> MLP:
    p = MLP(d_model, d_ff, dtype, device)
    with torch.no_grad():
        fill_dense(gen, p.w_gate, p.w_up, p.w_down)
    return p


def mlp(p: MLP, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h = act_fn(act)(x @ p.w_gate) * (x @ p.w_up)
    return h @ p.w_down


class Dense(nn.Module):
    """w (d_in, d_out) and an optional bias b (d_out,)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.w = _param(torch.empty((d_in, d_out), dtype=dtype,
                                    device=device))
        self.b = (_param(torch.zeros((d_out,), dtype=dtype, device=device))
                  if bias else None)


def init_dense(gen: torch.Generator, d_in: int, d_out: int,
               bias: bool = True, dtype=torch.float32, device=None) -> Dense:
    p = Dense(d_in, d_out, bias, dtype, device)
    with torch.no_grad():
        fill_dense(gen, p.w)
    return p


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w
    return y + p.b if p.b is not None else y
