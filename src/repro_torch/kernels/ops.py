"""Public kernel ops (port of ``repro.kernels.ops`` for the serving path).

Dispatch is by the device of the operands, not by an environment variable:
CPU tensors take each kernel's plain PyTorch version, CUDA tensors launch
the hand-written kernel (or raise; nothing falls back). The CUDA kernels
mask ragged L and M themselves, so none of the TPU padding exists here.
Embeddings and queries may be float32 or bfloat16; every op accumulates
in float32 and returns float32. ``doc_embs`` may also be a compressed corpus
(``kernels.quant.QuantTokens``): dispatch then reads the device of every
leaf, a CPU corpus takes the plain version (which dequantizes), a CUDA one
launches the kernel's ``_q`` entry point, which dequantizes in the kernel.

Launch shapes (``block_n`` for the dense ops, ``block_l`` for the reveal
ops) resolve as in the JAX package: an explicit argument wins, then the
tuned entry of the launch's shape bucket (:mod:`repro_torch.kernels.tuning`,
keyed by :func:`launch_dims`), then the op's default, which is the launch
made before tuning existed. The plain versions ignore them, as the JAX
package's ``ref`` lane does. :func:`autotune_op` times every candidate of
one bucket on the card and records the winner.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import tuning
from repro_torch.kernels.gather_maxsim import gather_maxsim_cuda, \
    gather_maxsim_plain, gather_maxsim_q_cuda
from repro_torch.kernels.masked_maxsim import check_tiles, \
    masked_maxsim_cuda, masked_maxsim_plain, masked_maxsim_q_cuda
from repro_torch.kernels.maxsim import maxsim_batch_cuda, \
    maxsim_batch_plain, maxsim_batch_q_cuda, maxsim_plain
from repro_torch.kernels.quant import QuantTokens, corpus_format, \
    corpus_leaves, corpus_reshape, format_ordinal, quantize_int8, \
    quantize_residual
from repro_torch.kernels.reveal import fused_reveal_cuda, \
    fused_reveal_plain, fused_reveal_q_cuda


def _on_cuda(op: str, doc_embs, *tensors: torch.Tensor) -> bool:
    """Whether an op runs on the card: every leaf of the corpus operand and
    every other operand on CUDA (True) or on the CPU (False)."""
    kinds = {t.device.type for t in (*corpus_leaves(doc_embs), *tensors)}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"{op}: operands must all be on the CPU or all on CUDA, "
                     f"got {sorted(kinds)}")


def _idx(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64).contiguous()


# ---------------------------------------------------------------------------
# Launch-shape resolution (the JAX package's _fmt_dims / _resolve)
# ---------------------------------------------------------------------------

def launch_dims(op: str, doc_shape: Sequence[int], q_shape: Sequence[int],
                fmt: str = "bf16",
                sel_shape: Optional[Sequence[int]] = None
                ) -> Dict[str, int]:
    """The tuning dims of one launch, from its operand shapes alone, with
    the JAX package's keys:

    * ``maxsim``: N, T, L, M from doc (N, L, M) and queries (T, M);
    * ``maxsim_batch``: B, N, T, L, M from (B, N, L, M) and (B, T, M);
    * ``fused_reveal`` / ``gather_maxsim``: B (frontier rows), G, L, M, D
      (doc rows), TQ (query rows) from (D, L, M), (TQ, M) and the
      selection's (B, G) ``sel_shape``;

    plus FMT, the format's power-of-two ordinal, for an int8 or residual
    corpus (``_fmt_dims``; a float corpus adds nothing)."""
    if op == "maxsim":
        (N, L, M), T = doc_shape, q_shape[0]
        dims = dict(N=N, T=T, L=L, M=M)
    elif op == "maxsim_batch":
        (B, N, L, M), T = doc_shape, q_shape[1]
        dims = dict(B=B, N=N, T=T, L=L, M=M)
    elif op in ("fused_reveal", "gather_maxsim"):
        (D, L, M), (B, G) = doc_shape, sel_shape
        dims = dict(B=B, G=G, L=L, M=M, D=D, TQ=q_shape[0])
    else:
        raise ValueError(f"launch_dims: unknown op {op!r}")
    return _fmt_dims({k: int(v) for k, v in dims.items()}, fmt)


def _fmt_dims(dims: Dict[str, int], fmt: str) -> Dict[str, int]:
    """Key tuning buckets per corpus format: a quantized launch adds an
    FMT dim (power-of-two ordinal) so int8 / residual learn their own
    launch shapes; a float corpus adds nothing."""
    if fmt != "bf16":
        dims["FMT"] = format_ordinal(fmt)
    return dims


def _resolve(op: str, dims: Dict[str, int], **overrides) -> Dict[str, int]:
    """Launch-shape resolution: explicit argument > tuned bucket > default.
    ``None`` defers; any given value (0 included: the reveal ops' rule by
    launch size) is explicit. A value no kernel shape takes raises
    ValueError here, before any launch."""
    cfg = tuning.lookup(op, dims)
    cfg.update({k: v for k, v in overrides.items() if v is not None})
    return tuning.check_config(op, cfg)


def maxsim_op(doc_embs: torch.Tensor, doc_tok_mask: torch.Tensor,
              queries: torch.Tensor, *,
              block_n: Optional[int] = None) -> torch.Tensor:
    """Dense MaxSim matrix H (N, T) from (N, L, M), (N, L), (T, M); on the
    card one launch of the batched kernel (B = 1) at ``block_n``."""
    cfg = _resolve("maxsim", launch_dims(
        "maxsim", doc_embs.shape, queries.shape, corpus_format(doc_embs)),
        block_n=block_n)
    if not _on_cuda("maxsim_op", doc_embs, doc_tok_mask, queries):
        return maxsim_plain(doc_embs, doc_tok_mask, queries)
    return _maxsim_batch_launch(
        corpus_reshape(doc_embs, 1, doc_embs.shape[0]), doc_tok_mask[None],
        queries[None], cfg["block_n"])[0]


def maxsim_scores_op(doc_embs: torch.Tensor, doc_tok_mask: torch.Tensor,
                     queries: torch.Tensor) -> torch.Tensor:
    """Full late-interaction scores S (N,) = sum_t H[:, t]. An all-masked
    doc's T >= 2 sentinels of -3e38 sum to -inf, as in JAX."""
    return maxsim_op(doc_embs, doc_tok_mask, queries).sum(-1)


def masked_maxsim_op(doc_embs: torch.Tensor, doc_tok_mask: torch.Tensor,
                     queries: torch.Tensor, tile_mask: torch.Tensor, *,
                     block_n: int = 8, block_t: int = 8) -> torch.Tensor:
    """Tile-masked MaxSim H (N, T) from (N, L, M), (N, L), (T, M): the
    MaxSim where the cell's (doc-block, token-block) tile is active,
    exactly 0 elsewhere. ``block_n``/``block_t`` are semantic: they define
    the grid ``tile_mask`` (ceil(N/block_n), ceil(T/block_t)) bool is
    written in. There is no ``block_l``: the CUDA kernels fix their own L
    tile. A malformed tile mask raises ValueError; it is never padded."""
    check_tiles("masked_maxsim_op", tile_mask, doc_embs.shape[0],
                queries.shape[0], block_n, block_t)
    if not _on_cuda("masked_maxsim_op", doc_embs, doc_tok_mask, queries,
                    tile_mask):
        return masked_maxsim_plain(doc_embs, doc_tok_mask, queries,
                                   tile_mask, block_n, block_t)
    quant = isinstance(doc_embs, QuantTokens)
    kernel = masked_maxsim_q_cuda if quant else masked_maxsim_cuda
    return kernel(doc_embs.contiguous(), doc_tok_mask.contiguous(),
                  queries.contiguous(), tile_mask.contiguous(), block_n,
                  block_t)


def maxsim_batch_op(doc_embs: torch.Tensor, doc_tok_mask: torch.Tensor,
                    queries: torch.Tensor, *,
                    block_n: Optional[int] = None) -> torch.Tensor:
    """Per-query-batched MaxSim H (B, N, T) — the dense serving scorer —
    from (B, N, L, M), (B, N, L), (B, T, M). No target materializes the
    (B, N, L, T) similarity tensor; all-masked docs give -3e38. The kernel
    runs ``block_n`` docs per block (resolved per shape bucket)."""
    cfg = _resolve("maxsim_batch", launch_dims(
        "maxsim_batch", doc_embs.shape, queries.shape,
        corpus_format(doc_embs)), block_n=block_n)
    if not _on_cuda("maxsim_batch_op", doc_embs, doc_tok_mask, queries):
        return maxsim_batch_plain(doc_embs, doc_tok_mask, queries)
    return _maxsim_batch_launch(doc_embs, doc_tok_mask, queries,
                                cfg["block_n"])


def _maxsim_batch_launch(doc_embs, doc_tok_mask, queries, block_n: int):
    quant = isinstance(doc_embs, QuantTokens)
    kernel = maxsim_batch_q_cuda if quant else maxsim_batch_cuda
    return kernel(doc_embs.contiguous(), doc_tok_mask.contiguous(),
                  queries.contiguous(), block_n)


def _reveal_dims(op: str, doc_embs, queries, tok_idx,
                 doc_rows: Optional[int]) -> Dict[str, int]:
    """A reveal launch's tuning dims; ``doc_rows`` stands for D where the
    rows are read in place from a larger tensor."""
    shape = tuple(doc_embs.shape)
    if doc_rows is not None:
        shape = (doc_rows, *shape[1:])
    return launch_dims(op, shape, queries.shape, corpus_format(doc_embs),
                       tok_idx.shape)


def gather_maxsim_op(doc_embs: torch.Tensor, doc_tok_mask: torch.Tensor,
                     queries: torch.Tensor, doc_idx: torch.Tensor,
                     tok_idx: torch.Tensor, *,
                     block_l: Optional[int] = None,
                     doc_rows: Optional[int] = None) -> torch.Tensor:
    """Gathered MaxSim for the bandit reveal: out[s, g] = max_j
    <E[doc_idx[s], j], Q[tok_idx[s, g]]> over valid j, (S,) x (S, G) ->
    (S, G). The pooled frontier passes query-offset token ids into a
    stacked (Q*T, M) table and doc ids into the resident corpus or a
    stacked (Q*N, L, M) block; this op is oblivious to either. ``doc_rows``
    is the D of the launch's tuning bucket (default: ``doc_embs``' rows):
    the Q*N candidate rows a frontier addresses in the resident corpus."""
    if doc_idx.shape[0] != tok_idx.shape[0]:
        raise ValueError(
            f"gather_maxsim_op: doc_idx has {doc_idx.shape[0]} rows but "
            f"tok_idx has {tok_idx.shape[0]} — every selection row needs "
            "one doc id and one token block")
    cfg = _resolve("gather_maxsim", _reveal_dims(
        "gather_maxsim", doc_embs, queries, tok_idx, doc_rows),
        block_l=block_l)
    if not _on_cuda("gather_maxsim_op", doc_embs, doc_tok_mask, queries,
                    doc_idx, tok_idx):
        return gather_maxsim_plain(doc_embs, doc_tok_mask, queries, doc_idx,
                                   tok_idx)
    quant = isinstance(doc_embs, QuantTokens)
    kernel = gather_maxsim_q_cuda if quant else gather_maxsim_cuda
    return kernel(doc_embs.contiguous(), doc_tok_mask.contiguous(),
                  queries.contiguous(), _idx(doc_idx), _idx(tok_idx),
                  cfg["block_l"])


def fused_reveal_op(doc_embs: torch.Tensor, doc_tok_mask: torch.Tensor,
                    queries: torch.Tensor, doc_idx: torch.Tensor,
                    tok_idx: torch.Tensor, new_mask: torch.Tensor, *,
                    block_l: Optional[int] = None,
                    doc_rows: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused reveal round: gathered MaxSim values for the frontier's
    selected cells plus the per-row sufficient-statistic deltas.

    doc_idx (F,), tok_idx (F, G), new_mask (F, G) ->
      (vals (F, G) f32, stats (F, 3) f32 = [d_count, d_total, d_total_sq])
    with the stats summed over the ``new_mask`` cells only. ``doc_rows``
    as in :func:`gather_maxsim_op`."""
    if doc_idx.shape[0] != tok_idx.shape[0] \
            or tok_idx.shape != new_mask.shape:
        raise ValueError(
            f"fused_reveal_op: doc_idx/tok_idx/new_mask rows disagree "
            f"({doc_idx.shape[0]}, {tuple(tok_idx.shape)}, "
            f"{tuple(new_mask.shape)}) — every selection row needs one doc "
            "id and matching (G,) token and freshness columns")
    cfg = _resolve("fused_reveal", _reveal_dims(
        "fused_reveal", doc_embs, queries, tok_idx, doc_rows),
        block_l=block_l)
    if not _on_cuda("fused_reveal_op", doc_embs, doc_tok_mask, queries,
                    doc_idx, tok_idx, new_mask):
        return fused_reveal_plain(doc_embs, doc_tok_mask, queries, doc_idx,
                                  tok_idx, new_mask)
    quant = isinstance(doc_embs, QuantTokens)
    kernel = fused_reveal_q_cuda if quant else fused_reveal_cuda
    return kernel(doc_embs.contiguous(), doc_tok_mask.contiguous(),
                  queries.contiguous(), _idx(doc_idx), _idx(tok_idx),
                  new_mask.contiguous(), cfg["block_l"])


# ---------------------------------------------------------------------------
# Autotuning entry point: synthetic-tensor runners per op
# ---------------------------------------------------------------------------

_FMT_BY_ORDINAL = {1: "bf16", 2: "int8", 4: "residual"}


def autotune_op(op: str, dims: Dict[str, int], *, repeats: int = 2,
                seed: int = 0, dtype=torch.float32, device="cuda"):
    """Time the op's candidate launch shapes at one shape bucket on
    synthetic tensors and record the winner in the tuning table.

    ``dims`` uses the keys :func:`launch_dims` derives from a launch, so a
    recorded entry is exactly what later launches of that bucket look up:

    * ``maxsim``:        N, T, L, M
    * ``maxsim_batch``:  B, N, T, L, M
    * ``gather_maxsim``: B, G, L, M, D (doc rows), TQ (query-token rows)
    * ``fused_reveal``:  B, G, L, M, D, TQ

    The tensors come from a ``torch.Generator`` seeded with ``seed`` on
    ``device``, unit rows in ``dtype``; a quantized bucket (FMT present)
    encodes the corpus into that format (the residual one against an
    8-row codebook), so the times are those of the ``_q`` kernels. Each
    candidate is timed on the card by CUDA events (``tuning.time_call``).

    Returns (best_config, {candidate-json: seconds}). On the CPU the ops
    ignore launch shapes, so this records nothing and returns the
    defaults unmeasured (the JAX package's ``ref`` lane).
    """
    if op not in tuning.DEFAULTS:
        raise ValueError(f"autotune_op: unknown op {op!r}")
    dev = torch.device(device)
    if dev.type != "cuda":
        return dict(tuning.DEFAULTS[op]), {}
    d = dict(dims)
    fmt = _FMT_BY_ORDINAL.get(int(d.get("FMT", 1)))
    if fmt is None:
        raise ValueError(f"autotune_op: unknown FMT ordinal {d['FMT']!r}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def unit(*shape):
        x = torch.randn(shape, generator=gen, device=dev)
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    def corpus(x):
        """The synthetic corpus in the bucket's resident format."""
        if fmt == "bf16":
            return x.to(dtype)
        if fmt == "int8":
            return quantize_int8(x)
        return quantize_residual(x, unit(8, x.shape[-1]))

    if op == "maxsim":
        E = corpus(unit(d["N"], d["L"], d["M"]))
        mask = torch.ones((d["N"], d["L"]), dtype=torch.bool, device=dev)
        Q = unit(d["T"], d["M"]).to(dtype)

        def runner(**cfg):
            return lambda: maxsim_op(E, mask, Q, **cfg)
    elif op == "maxsim_batch":
        E = corpus(unit(d["B"], d["N"], d["L"], d["M"]))
        mask = torch.ones((d["B"], d["N"], d["L"]), dtype=torch.bool,
                          device=dev)
        Q = unit(d["B"], d["T"], d["M"]).to(dtype)

        def runner(**cfg):
            return lambda: maxsim_batch_op(E, mask, Q, **cfg)
    else:
        D, TQ = d.get("D", max(d["B"], 8)), d.get("TQ", 64)
        E = corpus(unit(D, d["L"], d["M"]))
        mask = torch.ones((D, d["L"]), dtype=torch.bool, device=dev)
        Q = unit(TQ, d["M"]).to(dtype)
        di = torch.randint(0, D, (d["B"],), generator=gen, device=dev)
        ti = torch.randint(0, TQ, (d["B"], d["G"]), generator=gen,
                           device=dev)
        if op == "gather_maxsim":
            def runner(**cfg):
                return lambda: gather_maxsim_op(E, mask, Q, di, ti, **cfg)
        else:
            nm = torch.ones((d["B"], d["G"]), dtype=torch.bool, device=dev)

            def runner(**cfg):
                return lambda: fused_reveal_op(E, mask, Q, di, ti, nm, **cfg)
    return tuning.autotune(op, dims, runner, repeats=repeats, device=dev)
