"""Decision bounds for Col-Bandit (paper Sec. 4.2, App. A).

Port of ``repro.core.bounds``:
  Eq.  8   empirical mean mu_hat_i over observed cells
  Eq.  9   score proxy S_hat_i = T * mu_hat_i
  Eq. 10/11 deterministic hard bounds from per-cell support [a_it, b_it]
  Eq. 12   variance-adaptive empirical Bernstein-Serfling radius
  Eq. 13/14 hybrid decision interval (hard-clipped)
  Eq. 17   empirical std over observed cells
  Eq. 18   finite-population correction rho_n

Every function works on the last axis, so a leading query axis is a plain
batch dimension. All arithmetic is float32 in the JAX operation order: the
scalar factors (``alpha_ef * T``, ``log(c N / delta)``) are formed as
float32 tensors on the host, never as Python float64, because a last-ulp
difference in the radius can flip a stop or selection decision.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

_F32 = torch.float32


class Intervals(NamedTuple):
    s_hat: torch.Tensor      # (..., N) estimated total score  (Eq. 9)
    lcb: torch.Tensor        # (..., N) hybrid lower bound     (Eq. 13)
    ucb: torch.Tensor        # (..., N) hybrid upper bound     (Eq. 14)
    lb_hard: torch.Tensor    # (..., N)                        (Eq. 10)
    ub_hard: torch.Tensor    # (..., N)                        (Eq. 11)
    radius: torch.Tensor     # (..., N) r_i^eff                (Eq. 12)
    sigma: torch.Tensor      # (..., N)                        (Eq. 17)


def _f32(x: float) -> torch.Tensor:
    """A host float32 scalar: products of these round exactly as the JAX
    package's ``jnp.float32(x) * jnp.float32(y)`` constants do."""
    return torch.tensor(x, dtype=_F32)


def rho_n(n: torch.Tensor, T: int) -> torch.Tensor:
    """Finite-population correction, Eq. 18. Piecewise in n; collapses to 0
    at n == T so a fully-observed row has zero stochastic radius."""
    n = n.to(_F32)
    Tf = float(T)
    small = 1.0 - (n - 1.0) / Tf
    large = (1.0 - n / Tf) * (1.0 + 1.0 / torch.clamp(n, min=1.0))
    return torch.where(n <= Tf / 2.0, small, large)


def empirical_sigma(n: torch.Tensor, total: torch.Tensor,
                    total_sq: torch.Tensor) -> torch.Tensor:
    """Unbiased empirical std (Eq. 17); 0 where n <= 1 (radius handles it)."""
    nf = n.to(_F32)
    var = ((total_sq - total * total / torch.clamp(nf, min=1.0))
           / torch.clamp(nf - 1.0, min=1.0))
    return torch.sqrt(torch.clamp(var, min=0.0))


def serfling_radius(
    sigma: torch.Tensor,
    n: torch.Tensor,
    *,
    T: int,
    N: int,
    delta: float,
    alpha_ef,
    c: float = 1.0,
    bias_kappa: float = 0.0,
    value_range: float = 1.0,
) -> torch.Tensor:
    """Variance-adaptive decision radius, Eq. 12. ``alpha_ef`` is a float
    or a 0-d tensor.

    r_i = alpha_ef * T * sigma_i * sqrt(2 log(cN/delta) / n_i) * sqrt(rho_n),
    +inf where n_i <= 1. ``bias_kappa > 0`` adds the O(1/n) range term
    alpha_ef * kappa * T * (b-a) * log(cN/delta) / n.
    """
    nf = torch.clamp(n.to(_F32), min=1.0)
    log_term = torch.log(_f32(c) * _f32(N) / _f32(delta))
    # alpha_ef as a 0-d float32 tensor: a per-call fidelity knob stays on
    # its device, so there is no host read. log_term stays a 0-d tensor
    # too (2 log / n as reciprocal(n) * (2 log), the rounding of a Python
    # scalar's ``2 log / n``), so a trip reads no scalar back.
    alpha = torch.as_tensor(alpha_ef, dtype=_F32)
    r = (alpha * _f32(T) * sigma
         * torch.sqrt(nf.reciprocal() * (2.0 * log_term))
         * torch.sqrt(torch.clamp(rho_n(n, T), min=0.0)))
    if bias_kappa > 0.0:
        bias = (alpha * _f32(bias_kappa) * _f32(T)
                * _f32(value_range) * log_term)
        r = r + bias / nf
    return torch.where(n <= 1, torch.full_like(r, float("inf")), r)


def hard_bounds(
    total: torch.Tensor,          # (..., N) sum of revealed values
    revealed: torch.Tensor,       # (..., N, T) bool
    a: torch.Tensor,              # (..., N, T) per-cell lower support
    b: torch.Tensor,              # (..., N, T) per-cell upper support
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic bounds, Eq. 10/11: observed sum + support of the rest."""
    unrevealed = ~revealed
    lb = total + torch.where(unrevealed, a, 0.0).sum(dim=-1)
    ub = total + torch.where(unrevealed, b, 0.0).sum(dim=-1)
    return lb, ub


def intervals(
    n: torch.Tensor,
    total: torch.Tensor,
    total_sq: torch.Tensor,
    revealed: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    T: int,
    N: int,
    delta: float,
    alpha_ef,
    c: float = 1.0,
    bias_kappa: float = 0.0,
) -> Intervals:
    """Hybrid decision interval (Eq. 13/14), vectorized over documents."""
    lb_hard, ub_hard = hard_bounds(total, revealed, a, b)
    nf = n.to(_F32)
    mu = total / torch.clamp(nf, min=1.0)
    s_hat = float(T) * mu
    # n == 0: no empirical info; proxy = midpoint of the hard interval.
    s_hat = torch.where(n == 0, 0.5 * (lb_hard + ub_hard), s_hat)
    sigma = empirical_sigma(n, total, total_sq)
    r = serfling_radius(sigma, n, T=T, N=N, delta=delta, alpha_ef=alpha_ef,
                        c=c, bias_kappa=bias_kappa)
    # inf-radius arithmetic picks the hard bound in the min/max below.
    lcb = torch.maximum(lb_hard, s_hat - r)
    ucb = torch.minimum(ub_hard, s_hat + r)
    # Numerical guard: hybrid interval must stay non-empty & consistent.
    lcb = torch.minimum(lcb, ucb)
    return Intervals(s_hat=s_hat, lcb=lcb, ucb=ucb, lb_hard=lb_hard,
                     ub_hard=ub_hard, radius=r, sigma=sigma)
