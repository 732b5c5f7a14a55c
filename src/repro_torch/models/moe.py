"""Top-k routed Mixture-of-Experts (Mixtral 8x22B: 8e top-2; Moonlight:
64e top-6) with capacity-based dispatch.

The counterpart of ``src/repro/models/moe.py``, op for op. Dispatch is
batch-row-local (GShard-style capacity per sequence): a slot's position in
its expert is a cumulative count over the row's S * k slots in (token,
rank) order. Per-row capacity is ``int(max(1, round(S * k / E *
capacity_factor)))`` (Python's ``round``, half to even, as JAX computes
it), at most S * k; slots beyond it are dropped (the residual passes
through). ``no_drop=True`` (decode) sizes the capacity to S * k.

Every token of a row is routed and takes capacity, pads included, so the
tokens a forward drops depend on the row's padded length, as in JAX. The
router's top-k puts the lower expert first on ties (``stable_topk``, as
``jax.lax.top_k``), on float32 logits. Dropped slots point at slot
``capacity - 1`` of their expert and add a zero there, which may be a kept
token's slot: the dispatch adds (``index_add_``) and never assigns. The
per-expert products are plain batched matrix products (``einsum``), as in
JAX, which computes them outside any Pallas kernel.

``record_routing(model)`` collects each call's routing (``Routing`` plus
the top-k gap), and ``compare_routing`` holds two computations' routings
to each other: a token may route differently only where its top-k gap
(k-th minus (k+1)-th router logit) is below ``gap_tol`` in either
computation, a near-tie that float noise can flip, and every later
position of that row depends on it (causal attention, row-local capacity).
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.core.bandit import stable_topk
from repro_torch.models.layers import _param, act_fn, dense_init


class MoE(nn.Module):
    """router (D, E), w_gate / w_up (E, D, F), w_down (E, F, D)."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 dtype=torch.float32, device=None):
        super().__init__()

        def empty(*shape):
            return _param(torch.empty(shape, dtype=dtype, device=device))
        self.router = empty(d_model, n_experts)
        self.w_gate = empty(n_experts, d_model, d_ff)
        self.w_up = empty(n_experts, d_model, d_ff)
        self.w_down = empty(n_experts, d_ff, d_model)
        self.routing_log: Optional[List[RoutingRecord]] = None


def fill_moe(gen: torch.Generator, p: MoE) -> None:
    """JAX's initial distributions into ``p``, in place: the router as a
    dense layer, each expert's (d_in, d_out) N(0, 1/d_in), drawn in float32
    from ``gen``."""
    with torch.no_grad():
        p.router.copy_(dense_init(gen, *p.router.shape, p.router.dtype,
                                  p.router.device))
        for w in (p.w_gate, p.w_up, p.w_down):
            r = torch.randn(w.shape, generator=gen, dtype=torch.float32,
                            device=w.device)
            w.copy_((r * (1.0 / math.sqrt(w.shape[1]))).to(w.dtype))


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype=torch.float32, device=None) -> MoE:
    p = MoE(d_model, d_ff, n_experts, dtype, device)
    fill_moe(gen, p)
    return p


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

class Routing(NamedTuple):
    top_idx: torch.Tensor          # (B, S, k) int64, experts by rank
    top_w: torch.Tensor            # (B, S, k) f32, softmax over the k
    pos_in_expert: torch.Tensor    # (B, S*k) int64, slot order (token, rank)
    keep: torch.Tensor             # (B, S*k) bool, within capacity


class RoutingRecord(NamedTuple):
    routing: Routing
    capacity: int
    gap: torch.Tensor              # (B, S) f32: k-th minus (k+1)-th logit


def capacity_of(S: int, top_k: int, n_experts: int, capacity_factor: float,
                no_drop: bool = False) -> int:
    """Slots per expert and row."""
    if no_drop:
        capacity = S * top_k                                   # worst case
    else:
        capacity = int(max(1, round(S * top_k / n_experts
                                    * capacity_factor)))
    return min(capacity, S * top_k)


def gate_logits(p: MoE, x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) @ p.router.to(torch.float32)


def moe_routing(p: MoE, x: torch.Tensor, *, top_k: int,
                capacity: int) -> Routing:
    """The router's choice for x (B, S, D): experts, weights, each slot's
    position in its expert and whether it fits the capacity."""
    B, S, _ = x.shape
    E = p.router.shape[-1]
    top_vals, top_idx = stable_topk(gate_logits(p, x), top_k)  # (B, S, k)
    top_w = torch.softmax(top_vals, dim=-1)
    e_idx = top_idx.reshape(B, S * top_k)
    onehot = nn.functional.one_hot(e_idx, E)                   # (B, S*k, E)
    seen = torch.cumsum(onehot, dim=1)
    pos_in_expert = torch.gather(seen, 2, e_idx[..., None])[..., 0] - 1
    return Routing(top_idx, top_w, pos_in_expert, pos_in_expert < capacity)


def topk_gap(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """k-th minus (k+1)-th largest logit per token (inf where k = E)."""
    if top_k >= logits.shape[-1]:
        return torch.full(logits.shape[:-1], math.inf, device=logits.device)
    vals, _ = stable_topk(logits, top_k + 1)
    return vals[..., top_k - 1] - vals[..., top_k]


@contextlib.contextmanager
def record_routing(model: nn.Module) -> Iterator[List[RoutingRecord]]:
    """Within the block, every ``moe_ffn`` on a ``MoE`` of ``model``
    appends a ``RoutingRecord`` to the yielded list, in call order (a
    forward: one per layer in execution order). Blocks nest: the inner
    one's calls go to its list only."""
    log: List[RoutingRecord] = []
    mods = [m for m in model.modules() if isinstance(m, MoE)]
    outer = [m.routing_log for m in mods]
    for m in mods:
        m.routing_log = log
    try:
        yield log
    finally:
        for m, prev in zip(mods, outer):
            m.routing_log = prev


class RoutingDiff(NamedTuple):
    near_ties: int               # (layer, token)s that differ at a near-tie
    wide: int                    # ... that differ at a gap >= gap_tol
    first_tainted: torch.Tensor  # (B,) int64: first position of each row
                                 # that depends on a near-tie flip (S: none)


def routing_by_layer(log: Sequence[RoutingRecord], n_layers: int
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per layer, (top_idx (B, S, k), gap (B, S)) of a log of whole
    forwards (a prefill, then decode steps), concatenated along the
    sequence."""
    if not log or len(log) % n_layers:
        raise ValueError(f"{len(log)} routing records for {n_layers} layers")
    return [(torch.cat([r.routing.top_idx for r in log[i::n_layers]], 1),
             torch.cat([r.gap for r in log[i::n_layers]], 1))
            for i in range(n_layers)]


def compare_routing(want: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    got: Sequence[Tuple[torch.Tensor, torch.Tensor]], *,
                    gap_tol: float = 1e-4) -> RoutingDiff:
    """Two computations' per-layer (top_idx, gap) of the same tokens, in
    execution order. A token whose experts differ at an untainted position
    is a near-tie where either gap is below ``gap_tol`` (it taints its row
    from there on, for this and every later layer) and wide otherwise."""
    if len(want) != len(got):
        raise ValueError(f"{len(want)} layers against {len(got)}")
    B, S = want[0][1].shape
    pos = torch.arange(S)
    first = torch.full((B,), S, dtype=torch.int64)
    near = wide = 0
    for (idx_a, gap_a), (idx_b, gap_b) in zip(want, got):
        if idx_a.shape != idx_b.shape:
            raise ValueError(f"top_idx {tuple(idx_a.shape)} against "
                             f"{tuple(idx_b.shape)}")
        differ = (idx_a.cpu() != idx_b.cpu()).any(-1)
        differ &= pos[None, :] < first[:, None]
        tie = torch.minimum(gap_a.cpu(), gap_b.cpu()) < gap_tol
        near += int((differ & tie).sum())
        wide += int((differ & ~tie).sum())
        hit = torch.where(differ, pos[None, :], S).amin(-1)
        first = torch.minimum(first, hit)
    return RoutingDiff(near, wide, first)


# ---------------------------------------------------------------------------
# the FFN
# ---------------------------------------------------------------------------

def moe_ffn(p: MoE, x: torch.Tensor, *, top_k: int, act: str = "silu",
            capacity_factor: float = 1.25,
            no_drop: bool = False) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    B, S, D = x.shape
    E = p.router.shape[-1]
    capacity = capacity_of(S, top_k, E, capacity_factor, no_drop)
    r = moe_routing(p, x, top_k=top_k, capacity=capacity)
    if p.routing_log is not None:
        p.routing_log.append(RoutingRecord(
            r, capacity, topk_gap(gate_logits(p, x), top_k)))

    e_idx = r.top_idx.reshape(B, S * top_k)
    w = r.top_w.reshape(B, S * top_k) * r.keep.to(r.top_w.dtype)
    c_idx = torch.clamp(r.pos_in_expert, 0, capacity - 1)
    src = torch.arange(S, device=x.device).repeat_interleave(top_k)
    rows = torch.arange(B, device=x.device)[:, None] * E + e_idx
    slot = (rows * capacity + c_idx).reshape(-1)               # (B*S*k,)

    contrib = torch.where(r.keep[..., None], x[:, src], 0.0).to(x.dtype)
    buf = torch.zeros((B * E * capacity, D), dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot, contrib.reshape(-1, D))
    buf = buf.reshape(B, E, capacity, D)

    h = act_fn(act)(torch.einsum("becd,edf->becf", buf, p.w_gate)) * \
        torch.einsum("becd,edf->becf", buf, p.w_up)
    out_buf = torch.einsum("becf,efd->becd", h, p.w_down)     # (B, E, C, D)

    gathered = out_buf.reshape(B * E * capacity, D)[slot]      # (B*S*k, D)
    weighted = (gathered * w.reshape(-1, 1).to(gathered.dtype)).to(x.dtype)
    weighted = weighted.reshape(B, S, top_k, D)
    out = weighted[:, :, 0]             # JAX's scatter-add, rank by rank
    for j in range(1, top_k):
        out = out + weighted[:, :, j]
    return out


def moe_aux_loss(p: MoE, x: torch.Tensor, *, top_k: int) -> torch.Tensor:
    """Switch-style load-balancing loss (fraction-dispatched x router
    prob)."""
    E = p.router.shape[-1]
    logits = gate_logits(p, x)
    probs = torch.softmax(logits, dim=-1)
    _, top_idx = stable_topk(logits, top_k)
    counts = torch.zeros((E,), dtype=torch.float32, device=x.device)
    counts.index_add_(0, top_idx.reshape(-1),
                      torch.ones(top_idx.numel(), device=x.device))
    frac = counts / torch.clamp(counts.sum(), min=1.0)
    mean_prob = probs.mean(dim=(0, 1))
    return E * torch.sum(frac * mean_prob)
