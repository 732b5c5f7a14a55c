"""Bandit state and the reveal/update primitives shared by the sequential
(Algorithm 1) and block-synchronous bandits (port of ``repro.core.state``).

Where the JAX state carries a PRNG key, this one carries ``draw``: the
slot's draw state, a (1, 2) int64 tensor advanced by a
``core.draws.DrawSource`` (the pooled engine's chain body stacks Q slots:
(Q, 2)). The pooled engine's packed ``core.frontier.FrontierState`` carries
the same per-slot draw state across slices."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class BanditState(NamedTuple):
    values: torch.Tensor      # (R, T) f32 — revealed MaxSim values (0 if unrevealed)
    revealed: torch.Tensor    # (R, T) bool — the observation set Omega
    n: torch.Tensor           # (R,) i64 — |O_i|
    total: torch.Tensor       # (R,) f32 — sum of revealed values per row
    total_sq: torch.Tensor    # (R,) f32 — sum of squares
    rounds: torch.Tensor      # () or (Q,) i64 — loop iterations executed
    done: torch.Tensor        # () or (Q,) bool — stop flag
    draw: Optional[torch.Tensor] = None  # (Q, 2) i64 — per-slot draw state


def init_state(n_docs: int, n_tokens: int,
               draw: torch.Tensor) -> BanditState:
    """An empty solo state on ``draw``'s device."""
    dev = draw.device
    return BanditState(
        values=torch.zeros((n_docs, n_tokens), dtype=torch.float32,
                           device=dev),
        revealed=torch.zeros((n_docs, n_tokens), dtype=torch.bool,
                             device=dev),
        n=torch.zeros((n_docs,), dtype=torch.int64, device=dev),
        total=torch.zeros((n_docs,), dtype=torch.float32, device=dev),
        total_sq=torch.zeros((n_docs,), dtype=torch.float32, device=dev),
        rounds=torch.zeros((), dtype=torch.int64, device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev),
        draw=draw)


def reveal_cell(state: BanditState, h_full: torch.Tensor, i: torch.Tensor,
                t: torch.Tensor) -> BanditState:
    """Reveal one cell (i, t) (0-d index tensors) from the oracle matrix.
    No-op if already seen; no host read."""
    i, t = i.reshape(1), t.reshape(1)
    was = state.revealed[i, t]
    val = h_full[i, t].to(torch.float32)
    new = ~was
    newf = new.to(torch.float32)
    return state._replace(
        values=state.values.index_put(
            (i, t), torch.where(new, val, state.values[i, t])),
        revealed=state.revealed.index_put((i, t), torch.ones_like(was)),
        n=state.n.index_put((i,), state.n[i] + new.to(torch.int64)),
        total=state.total.index_put((i,), state.total[i] + newf * val),
        total_sq=state.total_sq.index_put(
            (i,), state.total_sq[i] + newf * val * val))


def reveal_mask(state: BanditState, h_full: torch.Tensor,
                mask: torch.Tensor) -> BanditState:
    """Reveal every cell where ``mask`` is True (vectorized, idempotent)."""
    new = mask & ~state.revealed
    newf = new.to(torch.float32)
    vals = h_full.to(torch.float32)
    return state._replace(
        values=torch.where(new, vals, state.values),
        revealed=state.revealed | new,
        n=state.n + new.sum(dim=-1),
        total=state.total + (newf * vals).sum(dim=-1),
        total_sq=state.total_sq + (newf * vals * vals).sum(dim=-1))


def coverage(state: BanditState,
             doc_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 6 — fraction of the (valid) matrix revealed."""
    if doc_mask is None:
        return state.revealed.to(torch.float32).mean()
    rev = (state.revealed & doc_mask[:, None]).sum()
    tot = doc_mask.sum() * state.revealed.shape[1]
    return rev.to(torch.float32) / torch.clamp(tot.to(torch.float32),
                                               min=1.0)
