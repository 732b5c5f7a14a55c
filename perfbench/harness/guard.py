"""The benchmark measures ``repro_torch`` alone: JAX and the JAX package
must not be loaded in the process that reports."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is one of ``FORBIDDEN``: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else list(names)
    return sorted({top_level(n) for n in names} & set(FORBIDDEN))
