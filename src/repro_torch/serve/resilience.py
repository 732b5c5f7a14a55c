"""Graceful fidelity degradation (port of the ``DegradeLadder`` of
``repro.serve.resilience``; ``Supervisor`` waits for the serving engine).

When a batch's tightest deadline headroom shrinks below the configured
thresholds, a serving engine moves down the ladder's rungs:

  level 0  full fidelity (no-op knobs)
  level 1  scale the effective ``alpha_ef`` (alpha_scale 2)
  level 2  scale it further AND cap the reveal rounds at 8
  level 3  maximal alpha + the tightest round cap, 4

The rungs and their knobs are the JAX package's. Its docstring says a
larger ``alpha_ef`` separates earlier; the Serfling radius grows with it,
so on its own (level 1) it separates later and may reveal more. The
round caps are what bound the work of levels 2 and 3.

The knobs are the per-call ``alpha_scale`` / ``round_cap`` of the bandit
serving steps (``retrieval.service``): a Python number or a 0-d tensor,
so changing rungs changes no shape, and level 0 is bit-identical to a
knob-less call.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["DegradeLadder"]


@dataclasses.dataclass(frozen=True)
class DegradeLadder:
    """Headroom-ratio -> (alpha_scale, round_cap) fidelity policy.

    ``headrooms`` are strictly-decreasing thresholds on the batch's
    tightest deadline-headroom ratio r = (deadline - now) / expected
    service time. ``r >= headrooms[0]`` is level 0 (full fidelity);
    crossing below ``headrooms[i]`` selects level i+1 with knobs
    ``alpha_scales[i]`` / ``round_caps[i]`` (a cap of 0 leaves the round
    budget alone). Values are per batch."""

    headrooms: Tuple[float, ...] = (1.0, 0.5, 0.25)
    alpha_scales: Tuple[float, ...] = (2.0, 4.0, 8.0)
    round_caps: Tuple[int, ...] = (0, 8, 4)

    def __post_init__(self):
        if not (len(self.headrooms) == len(self.alpha_scales)
                == len(self.round_caps)):
            raise ValueError("ladder fields must have equal length")
        if any(h2 >= h1 for h1, h2 in zip(self.headrooms,
                                          self.headrooms[1:])):
            raise ValueError("headroom thresholds must strictly decrease")
        if any(s < 1.0 for s in self.alpha_scales):
            raise ValueError("alpha_scales must be >= 1 (degrade, never "
                             "silently upgrade fidelity)")

    @property
    def n_levels(self) -> int:
        return len(self.headrooms) + 1

    def level_for(self, headroom_ratio: float) -> int:
        """0 = comfortable, len(headrooms) = maximally squeezed."""
        level = 0
        for h in self.headrooms:
            if headroom_ratio >= h:
                break
            level += 1
        return level

    def knobs(self, level: int) -> Tuple[float, int]:
        """(alpha_scale, round_cap) for a level; level 0 => (1.0, 0),
        which is bit-identical to no knobs at all."""
        if level <= 0:
            return 1.0, 0
        i = min(level, len(self.headrooms)) - 1
        return float(self.alpha_scales[i]), int(self.round_caps[i])
