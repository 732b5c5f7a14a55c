"""The yardstick's arithmetic: the card's peaks, a kernel launch's bound,
and the operations and bytes that served requests need.

A bound is the least time the card could take: the larger of the bytes
the inputs need over the memory bandwidth and the operations over the
float32 peak. Every input byte counts once and every output byte once,
whatever the kernel reads again; where the work depends on the data (the
cells a bandit reveals), the operations are those these inputs needed.
"""
from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 outside the tensor
# cores (dense), and the 80 GB of device memory.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
MEMORY_BYTES = 80e9


def bound_s(nbytes: float, flops: float) -> Tuple[float, str]:
    """(seconds, what bounds it) at the card's peaks."""
    t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def maxsim_launch(valid_tokens: float, B: int, N: int, L: int, T: int,
                  M: int, esz: int = 4) -> Tuple[float, float]:
    """(bytes, flops) of one dense ``maxsim`` launch over (B, N, L, M)
    candidates with ``valid_tokens`` unmasked doc tokens in all: the valid
    tokens, the (B, N, L) byte mask, the queries and the (B, N, T) f32
    output; two operations per query token, valid doc token and width."""
    nbytes = valid_tokens * M * esz + B * N * L + B * T * M * esz \
        + B * N * T * 4
    return nbytes, 2.0 * T * M * valid_tokens


def reveal_launch(valid_flops: float, valid_u: float, docs_u: float,
                  toks_u: float, F: int, G: int, L: int, M: int,
                  esz: int = 4, fused: bool = True) -> Tuple[float, float]:
    """(bytes, flops) of one reveal launch of F frontier rows with G query
    tokens each: the valid tokens, masks and query rows it touches, each
    distinct one once (``valid_u``, ``docs_u``, ``toks_u``), the doc and
    token indices, and the outputs (fused: the new-cell mask read, the
    values written and 12 bytes of stats a row); operations over the valid
    tokens of the selected docs with repeats (``valid_flops``)."""
    nbytes = (valid_u * M * esz + docs_u * L + toks_u * M * esz + F * 8
              + F * G * 8)
    nbytes += F * G + F * G * 4 + F * 12 if fused else F * G * 4
    return nbytes, 2.0 * G * M * valid_flops


def request_reveal(cand_tokens: float, n_cand: int, T: int, M: int,
                   reveal_fraction: float, k: int,
                   esz: int = 4) -> Tuple[float, float]:
    """(bytes, flops) the reveal kernels need for one bandit request: each
    valid token of its candidates read once (the pooled frontier's first
    reveal takes one cell of every valid candidate), its query and its
    top-k ids and scores; operations on the revealed share of its
    candidate cells, each cell 2 M L_i (``cand_tokens`` = sum of L_i)."""
    nbytes = cand_tokens * M * esz + n_cand + T * M * esz + k * 8
    return nbytes, reveal_fraction * T * 2.0 * M * cand_tokens


def request_dense(cand_tokens: float, n_cand: int, T: int, M: int,
                  esz: int = 4) -> Tuple[float, float]:
    """(bytes, flops) of one request's dense MaxSim over its candidates:
    every valid token read once, the masks, the query and the (N, T)
    cells written; every cell computed."""
    nbytes = cand_tokens * M * esz + n_cand + T * M * esz + n_cand * T * 4
    return nbytes, T * 2.0 * M * cand_tokens


def stage1_flops(corpus_tokens: float, T: int, M: int) -> float:
    """Operations of one query's stage-1 similarity product over every
    token slot of the corpus: 2 T (C L) M."""
    return 2.0 * T * corpus_tokens * M
