"""Stacked bandit statistics shared by the pooled engine's chain round body
(port of ``repro.core.state``).

The JAX state also carries the PRNG key; here the random draws come from a
``core.frontier.DrawSource`` handed to the engine, so the state holds
statistics and loop bookkeeping only."""
from __future__ import annotations

from typing import NamedTuple

import torch


class BanditState(NamedTuple):
    values: torch.Tensor      # (R, T) f32 — revealed MaxSim values (0 if unrevealed)
    revealed: torch.Tensor    # (R, T) bool — the observation set Omega
    n: torch.Tensor           # (R,) i64 — |O_i|
    total: torch.Tensor       # (R,) f32 — sum of revealed values per row
    total_sq: torch.Tensor    # (R,) f32 — sum of squares
    rounds: torch.Tensor      # (Q,) i64 — loop iterations executed
    done: torch.Tensor        # (Q,) bool — stop flag
