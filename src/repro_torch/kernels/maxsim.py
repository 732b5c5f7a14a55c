"""Dense MaxSim: the dense rerank flavor's scorer and the exhaustive oracle.

CUDA kernel ``csrc/maxsim.cu`` (``colbandit_maxsim``) replaces the TPU
kernel ``src/repro/kernels/maxsim.py:maxsim`` (``_maxsim_kernel``), which
``ops.maxsim_batch_op`` vmapped over the query batch; here the batch is a
grid axis of one launch. Bound on the H100: device-memory bytes and the
f32 issue rate about equally at T = 32, M = 128 (16 flop per valid doc
byte against a ridge of ~20). The body compacts each doc's valid tokens,
stages them with ``cp.async`` two chunks ahead, and register-tiles the
product (4 doc rows x 4 query rows a thread); the design notes are in the
source. The (B, N, L, T) similarity tensor is never built.

``colbandit_maxsim_q`` (same source, same body) replaces the quantized TPU
kernel ``_maxsim_q_kernel``: it reads a ``QuantTokens`` corpus (int8 rows,
per-row scales, optional centroid codes into a codebook shared across the
batch), stages the int8 rows raw and dequantizes each element once into
an f32 tile. Bound on the H100: operations (~63 flop per int8 byte at the
serving shape, above the ridge). Its values equal ``colbandit_maxsim`` on
the dequantized corpus bit for bit.

The docs per block, ``block_n``, are a launch argument (1, 2 or 4; 2 by
default, the shape before tuning existed), chosen per shape bucket by
``kernels/tuning.py``; no cell depends on it. The shared memory a launch
needs comes from the kernel's own ``colbandit_maxsim_smem_bytes`` at that
``block_n``: a residual codebook too large to stage beside the rest is
read from global memory instead, so only the staged rows, the compute tile
and the per-token lists (which grow with L, M and ``block_n``) can exceed a
block's shared memory. A ``block_n`` the kernel is not built for, or such a
size, raises ValueError before any launch.

``maxsim_batch_plain`` is the plain PyTorch version of both
(``kernels/ref.py``'s ``maxsim_batch_ref``: an L-chunked running max that
dequantizes one chunk at a time, again without the (B, N, L, T) tensor).
Tests and ``chip_smoke.py`` compare the kernels with it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant import QuantTokens, dense_rows, dequant_block

_NEG = -3e38
# Docs per block the dense kernel is built for (csrc/maxsim.cu's
# dense_docs_ok), and the masked kernel's one.
BLOCK_N = (1, 2, 4)
MASKED_DOCS = 2


def _check_maxsim(name, doc_embs, doc_tok_mask, queries, smem_bytes):
    """Validate the operands of a maxsim-family launch and return its empty
    (B, N, T) f32 output. ``smem_bytes(L, M)`` is the shared memory one
    block of the kernel takes; more than the card's raises ValueError."""
    _build.require(len(doc_embs.shape) == 4 and queries.dim() == 3
                   and doc_tok_mask.dim() == 3, name,
                   "expected doc_embs (B,N,L,M), doc_tok_mask (B,N,L), "
                   "queries (B,T,M)")
    B, N, L, M = doc_embs.shape
    _build.require(tuple(doc_tok_mask.shape) == (B, N, L)
                   and queries.shape[0] == B and queries.shape[2] == M,
                   name, f"shape mismatch: {tuple(doc_embs.shape)}, "
                   f"{tuple(doc_tok_mask.shape)}, {tuple(queries.shape)}")
    _build.require(queries.dtype in _build.FLOAT_TYPES
                   and doc_tok_mask.dtype == torch.bool, name,
                   "queries must be float32/bfloat16, the mask bool")
    _build.require(queries.is_contiguous() and doc_tok_mask.is_contiguous(),
                   name, "operands must be contiguous")
    _build.require(B <= 65535 and N < 2 ** 31, name,
                   f"unsupported sizes B={B}, N={N}")
    smem = smem_bytes(L, M)
    _build.require(smem <= _build.SHARED_MEM_BYTES, name,
                   f"L={L}, M={M}: the staged doc rows, compute tile and "
                   f"per-token lists of a block need {smem} bytes of shared "
                   f"memory, more than the card's {_build.SHARED_MEM_BYTES} "
                   "a block (a codebook is not staged where it does not "
                   "fit)")
    return torch.empty((B, N, queries.shape[1]), dtype=torch.float32,
                       device=queries.device)


def _dense_smem(elem_bytes: int, kc: int = 0, scaled: bool = False,
                docs: int = MASKED_DOCS):
    """``smem_bytes`` of the dense body at ``docs`` docs per block for rows
    of ``elem_bytes`` bytes an element (scaled rows and ``kc`` codebook rows
    for ``_q``)."""
    def smem_bytes(L, M):
        return _build.library("maxsim.cu").colbandit_maxsim_smem_bytes(
            L, M, elem_bytes, int(scaled), kc, docs)
    return smem_bytes


def check_block_n(name: str, block_n) -> int:
    """``block_n`` as an int, or ValueError where the dense kernel is not
    built for it (never a quiet fall back to the default)."""
    _build.require(isinstance(block_n, int) and block_n in BLOCK_N, name,
                   f"block_n={block_n!r} is not one of the dense kernel's "
                   f"docs per block {BLOCK_N}")
    return block_n


def maxsim_batch_cuda(doc_embs: torch.Tensor, doc_tok_mask: torch.Tensor,
                      queries: torch.Tensor, block_n: int = 2
                      ) -> torch.Tensor:
    """H (B, N, T) f32 from doc_embs (B, N, L, M), doc_tok_mask (B, N, L)
    bool and queries (B, T, M), on the card, ``block_n`` docs per block.
    f32 or bf16 inputs, f32 accumulation; -3e38 for an all-masked doc."""
    name = "maxsim"
    block_n = check_block_n(name, block_n)
    _build.require(isinstance(doc_embs, torch.Tensor), name,
                   "a QuantTokens corpus goes to maxsim_batch_q_cuda")
    dev = _build.require_cuda(name, doc_embs, doc_tok_mask, queries)
    _build.require(doc_embs.dtype in _build.FLOAT_TYPES
                   and doc_embs.is_contiguous(), name,
                   "doc_embs must be contiguous float32/bfloat16")
    out = _check_maxsim(name, doc_embs, doc_tok_mask, queries,
                        _dense_smem(doc_embs.element_size(), docs=block_n))
    if out.numel() == 0:
        return out
    B, N, L, M = doc_embs.shape
    lib = _build.library("maxsim.cu")
    with torch.cuda.device(dev):
        status = lib.colbandit_maxsim(
            doc_embs.data_ptr(), doc_tok_mask.data_ptr(), queries.data_ptr(),
            out.data_ptr(), B, N, L, M, queries.shape[1],
            int(doc_embs.dtype == torch.bfloat16),
            int(queries.dtype == torch.bfloat16), block_n,
            _build.stream_ptr(dev))
    _build.check_launch(status, name)
    return out


def maxsim_batch_q_cuda(doc_embs: QuantTokens, doc_tok_mask: torch.Tensor,
                        queries: torch.Tensor, block_n: int = 2
                        ) -> torch.Tensor:
    """``maxsim_batch_cuda`` on a compressed corpus: doc_embs a
    ``QuantTokens`` with a (B, N, L, M) int8 payload, (B, N, L) scales (and
    codes), and a shared (Kc, M) codebook for the residual format."""
    name = "maxsim_q"
    block_n = check_block_n(name, block_n)
    _build.require(isinstance(doc_embs, QuantTokens), name,
                   "doc_embs must be a QuantTokens")
    dev = _build.require_cuda(name, *(a for a in doc_embs if a is not None),
                              doc_tok_mask, queries)
    qargs, s_bf16 = _build.quant_args(name, doc_embs)
    M = doc_embs.shape[-1]
    out = _check_maxsim(name, doc_embs, doc_tok_mask, queries,
                        _dense_smem(1, qargs[-1], scaled=True, docs=block_n))
    if out.numel() == 0:
        return out
    B, N, L, _ = doc_embs.shape
    lib = _build.library("maxsim.cu")
    with torch.cuda.device(dev):
        status = lib.colbandit_maxsim_q(
            *qargs, doc_tok_mask.data_ptr(), queries.data_ptr(),
            out.data_ptr(), B, N, L, M, queries.shape[1], s_bf16,
            int(queries.dtype == torch.bfloat16), block_n,
            _build.stream_ptr(dev))
    _build.check_launch(status, name)
    return out


def maxsim_plain(doc_embs, doc_tok_mask: torch.Tensor,
                 queries: torch.Tensor) -> torch.Tensor:
    """Dense MaxSim matrix (Eq. 4): (N, L, M), (N, L), (T, M) -> (N, T) f32,
    H[i, t] = max_j <e_ij, q_t> over valid j (``ref.maxsim_ref``).
    ``doc_embs`` may be a ``QuantTokens``."""
    sims = torch.einsum("nlm,tm->nlt", dense_rows(doc_embs),
                        queries.to(torch.float32))
    sims = torch.where(doc_tok_mask[:, :, None], sims, _NEG)
    return sims.max(dim=1).values


def maxsim_batch_plain(doc_embs, doc_tok_mask: torch.Tensor,
                       queries: torch.Tensor, *,
                       block_l: int = 64) -> torch.Tensor:
    """Per-query-batched MaxSim streamed over document tokens
    (``ref.maxsim_batch_ref``): (B, N, L, M), (B, N, L), (B, T, M) ->
    (B, N, T). The peak temporary is (B, N, block_l, T); a ``QuantTokens``
    corpus is dequantized one L-chunk at a time."""
    Bq, N, L, _ = doc_embs.shape
    T = queries.shape[1]
    q = queries.to(torch.float32)
    h = torch.full((Bq, N, T), _NEG, dtype=torch.float32,
                   device=doc_tok_mask.device)
    for l0 in range(0, L, max(block_l, 1)):
        sl = slice(l0, l0 + block_l)
        if isinstance(doc_embs, QuantTokens):
            e_c = dequant_block(
                doc_embs.data[:, :, sl], doc_embs.scales[:, :, sl],
                None if doc_embs.codes is None else doc_embs.codes[:, :, sl],
                doc_embs.codebook)
        else:
            e_c = doc_embs[:, :, sl].to(torch.float32)
        sims = torch.einsum("bnlm,btm->bnlt", e_c, q)
        sims = torch.where(doc_tok_mask[:, :, sl, None], sims, _NEG)
        h = torch.maximum(h, sims.max(dim=2).values)
    return h
