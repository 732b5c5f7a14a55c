"""Per-slot random draws: the port's counterpart of the JAX package's
per-query PRNG keys.

In JAX each query carries a key in its bandit state and splits it every
round, so a query's draws depend on nothing but its own key and its own
round count. Here the same holds for a *draw state*: a (Q, 2) int64 tensor,
two words per slot, carried in ``BanditState.draw`` and
``FrontierState.draw`` and advanced by a :class:`DrawSource`. A carried
slot resumes its own draw state, a fresh slot starts from its seed, and
every slot advances once per trip, retired or not, as JAX splits every
query's key every trip. That is what lets a paused-and-resumed run, or a
slot refilled mid-stream, replay the one-shot run draw for draw.

:class:`TorchDraws` is counter-based: a slot's bits are a 32-bit integer
hash of (its seed, its own trip count, the draw's index), computed in int64
tensor ops on the seeds' device. It holds no generator and reads nothing
back to the host, so a trip that uses it is a function of tensors alone.
Its bits are reproducible on any device, and they are not JAX's: the
parity tests replay JAX's key chain through their own ``DrawSource``.
"""
from __future__ import annotations

import functools
from typing import Optional, Protocol, Sequence, Tuple

import torch

# A slot's draw state is this many int64 words (a JAX threefry key's two
# uint32 words, or TorchDraws' [key, trip count]).
DRAW_WIDTH = 2

_M32 = 0xFFFFFFFF
# Odd multipliers below 2**31, so that a 32-bit value times one stays below
# 2**63 and int64 arithmetic never overflows.
_C1, _C2, _WEYL = 0x7FEB352D, 0x2C1B3C6D, 0x61C88647
# Stream tags: independent draws of one seed.
_ROUND, _INIT, _WARM, _UNIFORM, _SPLIT_HI, _SPLIT_LO = (
    0x52, 0x17, 0x2B, 0x3D, 0x4E, 0x61)


class DrawSource(Protocol):
    """The random draws of the bandit engines, as functions of tensors.

    ``seeds`` are a source's per-slot seeds (``key``/``keys`` make them
    from an int, as ``jax.random.key``/``split`` do); draw states are
    (Q, DRAW_WIDTH) int64 tensors. The pooled and block bandits use
    ``init`` and ``round`` (JAX's ``split(key)`` then, every round,
    ``split(key, 3)`` into a uniform and a Gumbel draw); Algorithm 1 uses
    ``init_alg1`` (JAX's ``split(key, 3)``) and ``round`` with W = 1; the
    Doc-Uniform baseline uses ``uniform``."""

    def key(self, seed: int, device="cuda") -> torch.Tensor:
        """One slot's seed for the int ``seed``."""

    def keys(self, seed: int, n: int, device="cuda") -> torch.Tensor:
        """``n`` per-query seeds derived from the int ``seed``."""

    def init(self, seeds: torch.Tensor, fresh: Optional[torch.Tensor],
             state: Optional[torch.Tensor], N: int, T: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(draw state (Q, 2), init-reveal token per candidate (Q, N) in
        [0, T)). Fresh slots (all when ``fresh`` is None) start from their
        seed; the others keep their row of ``state``."""

    def round(self, state: torch.Tensor, W: int, T: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(advanced state, exploration uniforms (Q, W, 1), Gumbel noise
        (Q, W, T)) for one trip of every slot."""

    def init_alg1(self, seed: torch.Tensor, N: int, T: int, n_warm: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Algorithm 1's start: (draw state (1, 2), init token per doc (N,),
        the first ``n_warm`` cells (flat ids) of a random permutation of
        the N*T cells)."""

    def uniform(self, seed: torch.Tensor,
                shape: Sequence[int]) -> torch.Tensor:
        """Uniform [0, 1) float32 noise of ``shape`` for one seed."""


def _mix(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer hash of x in [0, 2**32) (int64 tensor):
    xorshift-multiply rounds, every product below 2**63."""
    x = x ^ (x >> 16)
    x = (x * _C1) & _M32
    x = x ^ (x >> 15)
    x = (x * _C2) & _M32
    return x ^ (x >> 16)


def _seed_key(seeds: torch.Tensor, stream: int) -> torch.Tensor:
    """A 32-bit key per 64-bit seed and stream tag."""
    seeds = seeds.to(torch.int64)
    return _mix(_mix((seeds & _M32) ^ stream) ^ ((seeds >> 32) & _M32))


def _bits(x: torch.Tensor, n: int) -> torch.Tensor:
    """n hashed 32-bit words per key: (Q,) -> (Q, n), a Weyl sequence over
    the index hashed once."""
    j = torch.arange(0, n * _WEYL, _WEYL, device=x.device, dtype=torch.int64)
    return _mix((x[:, None] + j) & _M32)


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """float32 in the open interval (0, 1): the top 23 bits plus half a
    step, (2m + 1) * 2**-24, exact in float32."""
    return ((bits >> 8) | 1) * 2.0 ** -24


@functools.lru_cache(maxsize=None)
def _positions(n: int, device: torch.device) -> torch.Tensor:
    """0 .. n-1 as a (1, n) int64 tensor, one per (n, device)."""
    return torch.arange(n, dtype=torch.int64, device=device)[None]


@functools.lru_cache(maxsize=None)
def _next_trip(device: torch.device) -> torch.Tensor:
    """The draw-state increment of one trip: [0, 1]."""
    return torch.tensor([0, 1], dtype=torch.int64, device=device)


class TorchDraws:
    """Counter-based draws: a slot's state is [key, trip count], and trip
    c's n words are ``_mix(key + (c*n + i) * _WEYL)``, i < n: one hash
    pass per trip. Stateless itself; ``key``/``keys`` make seeds on the
    card unless asked for another device, and every other method runs on
    the device of its inputs."""

    def key(self, seed: int, device="cuda") -> torch.Tensor:
        return torch.tensor(int(seed), dtype=torch.int64, device=device)

    def keys(self, seed: int, n: int, device="cuda") -> torch.Tensor:
        s = self.key(seed, device)[None]
        hi = _bits(_seed_key(s, _SPLIT_HI), n)[0]
        lo = _bits(_seed_key(s, _SPLIT_LO), n)[0]
        return (hi << 31) | (lo >> 1)          # in [0, 2**63)

    def init(self, seeds, fresh, state, N, T):
        seeds = seeds.reshape(-1)
        new = torch.stack([_seed_key(seeds, _ROUND),
                           torch.zeros_like(seeds, dtype=torch.int64)], 1)
        t0 = (_bits(_seed_key(seeds, _INIT), N) * T) >> 32
        if state is not None and fresh is not None:
            new = torch.where(fresh[:, None], new, state)
        return new, t0

    def round(self, state, W, T):
        n = W * (T + 1)
        # Trip c's draws are the Weyl sequence of the slot's key at stream
        # positions c*n .. c*n + n - 1, hashed once. A position is taken
        # mod 2**32, so position * _WEYL + key < 2**63.
        pos = (state[:, 1:] * n + _positions(n, state.device)) & _M32
        f = _unit(_mix((state[:, :1] + pos * _WEYL) & _M32))
        Q = state.shape[0]
        u = f[:, :W].reshape(Q, W, 1)
        g = -torch.log(-torch.log(f[:, W:].reshape(Q, W, T)))
        return state + _next_trip(state.device), u, g

    def init_alg1(self, seed, N, T, n_warm):
        state, t0 = self.init(seed.reshape(1), None, None, N, T)
        order = torch.argsort(_bits(_seed_key(seed.reshape(1), _WARM),
                                    N * T)[0], stable=True)
        return state, t0[0], order[:n_warm]

    def uniform(self, seed, shape):
        n = 1
        for s in shape:
            n *= int(s)
        bits = _bits(_seed_key(seed.reshape(1), _UNIFORM), n)[0]
        return ((bits >> 8).to(torch.float32) * 2.0 ** -24).reshape(
            tuple(shape))


TORCH_DRAWS = TorchDraws()
