"""Compressed resident-corpus formats: int8 rows and centroid residuals
(port of ``repro.kernels.quant``).

Formats (``CORPUS_FORMATS``):

  * ``bf16``     - uncompressed passthrough: the corpus stays a plain tensor
                   at its source residency (bf16 in, bf16 resident; f32 in,
                   f32 resident).
  * ``int8``     - per-(doc, token)-row symmetric quantization: for each
                   length-M row, scale = absmax/127 (stored bf16), payload
                   int8; ~M + 2 bytes per row against 4M uncompressed.
  * ``residual`` - centroid id + int8 residual: each row is assigned its
                   nearest codebook centroid (the centroid router's
                   spherical k-means centroids double as the codebook) and
                   only the residual is int8-quantized. Decoded row =
                   data * scale + codebook[code].

The CUDA kernels (``csrc/*.cu``, ``_q`` entry points) rebuild each row in
registers and shared memory right before the float32 dot, so a dequantized
candidate never reaches device memory. Their per-element arithmetic is
``dequant_block``'s, rounded step by step, so a kernel on a ``QuantTokens``
equals the float32 kernel on ``dequantize`` of it bit for bit.

The encoders are torch functions that run on the input's device (or on
``device``), chunked over the leading axis so no temporary exceeds a few
hundred MB. Their math is the JAX package's exactly: absmax / 127 in f32,
the scale rounded to ``scale_dtype`` first, then round-half-to-even of
x / scale clipped to +-127; residual codes are the first argmax of x . cb^T.

The TPU padding helpers (``corpus_pad_to``) are not ported: the CUDA
kernels mask ragged L and M themselves.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

CORPUS_FORMATS = ("bf16", "int8", "residual")

# int8 symmetric range. 127 (not 128) keeps the code range symmetric so
# dequantization has no bias term.
_QMAX = 127.0
# Elements of float32 input encoded per chunk (256 MB per f32 temporary).
_CHUNK_ELEMS = 1 << 26


class QuantTokens(NamedTuple):
    """A quantized token-embedding tensor with payload shape (..., L, M).

    data:     int8 (..., L, M) quantized rows (or residuals)
    scales:   (..., L) per-row dequant scale, bf16 by default (or f32)
    codes:    (..., L) int32 centroid id per row, residual format only
    codebook: (Kc, M) f32 shared codebook, residual format only (never
              gathered or reshaped with the doc axis)
    """
    data: torch.Tensor
    scales: torch.Tensor
    codes: Optional[torch.Tensor] = None
    codebook: Optional[torch.Tensor] = None

    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def fmt(self) -> str:
        return "residual" if self.codes is not None else "int8"

    def to(self, device) -> "QuantTokens":
        """Every leaf on ``device``."""
        return QuantTokens(*(None if a is None else a.to(device)
                             for a in self))

    def contiguous(self) -> "QuantTokens":
        """Every leaf contiguous (what the kernels take)."""
        return QuantTokens(*(None if a is None else a.contiguous()
                             for a in self))


def corpus_format(x) -> str:
    """Format tag of a corpus operand (plain tensor -> 'bf16')."""
    return x.fmt if isinstance(x, QuantTokens) else "bf16"


def format_ordinal(fmt: str) -> int:
    """Power-of-two ordinal of a format (the JAX package keys its tuning
    buckets by it)."""
    if fmt not in CORPUS_FORMATS:
        raise ValueError(f"unknown corpus format {fmt!r}; "
                         f"expected one of {CORPUS_FORMATS}")
    return 1 << CORPUS_FORMATS.index(fmt)


def corpus_leaves(x) -> List[torch.Tensor]:
    """Non-None leaves of a corpus operand (plain tensor -> [tensor])."""
    if isinstance(x, QuantTokens):
        return [a for a in x if a is not None]
    return [x]


def corpus_nbytes(x) -> int:
    """Resident bytes of a corpus operand, counting every quantization
    sidecar (scales, codes, codebook)."""
    return sum(a.numel() * a.element_size() for a in corpus_leaves(x))


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------

def _encode_rows(x: torch.Tensor, scale_dtype):
    """Symmetric per-row int8 encode of f32 (..., M) rows -> (int8, scales).
    The scale is rounded to ``scale_dtype`` before x is divided by it, so
    the pair (data, scale) is self-consistent."""
    absmax = x.abs().amax(dim=-1)
    # A tensor divisor: CUDA turns division by a host scalar into a
    # multiply by its reciprocal, which can differ from numpy in the last bit.
    qmax = torch.full_like(absmax, _QMAX)
    scale = (absmax / qmax).to(scale_dtype)
    s32 = scale.to(torch.float32)
    safe = torch.where(s32 > 0, s32, torch.ones_like(s32))
    data = torch.round(x / safe[..., None]).clamp_(-_QMAX, _QMAX)
    return data.to(torch.int8), scale


def _chunks(x: torch.Tensor):
    """Row ranges over the leading axis of at most ``_CHUNK_ELEMS``
    elements each."""
    per = max(1, x[:1].numel())
    step = max(1, _CHUNK_ELEMS // per)
    for c0 in range(0, x.shape[0], step):
        yield c0, min(c0 + step, x.shape[0])


def _encode(embs, scale_dtype, device, codebook=None) -> QuantTokens:
    x_all = torch.as_tensor(embs)
    if x_all.dim() < 1:
        raise ValueError("embeddings must have at least one axis")
    dev = x_all.device if device is None else torch.device(device)
    lead = x_all.shape[:-1]
    data = torch.empty(x_all.shape, dtype=torch.int8, device=dev)
    scales = torch.empty(lead, dtype=scale_dtype, device=dev)
    codes = cb = None
    if codebook is not None:
        codes = torch.empty(lead, dtype=torch.int32, device=dev)
        cb = torch.as_tensor(codebook).to(device=dev, dtype=torch.float32)
    for c0, c1 in _chunks(x_all):
        x = x_all[c0:c1].to(device=dev, dtype=torch.float32)
        if cb is not None:
            code = torch.argmax(x @ cb.T, dim=-1)
            codes[c0:c1] = code.to(torch.int32)
            x = x - cb[code]
        data[c0:c1], scales[c0:c1] = _encode_rows(x, scale_dtype)
    return QuantTokens(data=data, scales=scales, codes=codes, codebook=cb)


def quantize_int8(embs, scale_dtype=torch.bfloat16,
                  device=None) -> QuantTokens:
    """Per-(doc, token)-row symmetric int8 quantization.

    All-zero rows get scale 0 and decode to exact zeros; rows with absmax
    anywhere up to f32 max are safe (absmax/127 never overflows). Runs on
    ``embs``'s device unless ``device`` names another, chunk by chunk."""
    return _encode(embs, scale_dtype, device)


def quantize_residual(embs, codebook, scale_dtype=torch.bfloat16,
                      device=None) -> QuantTokens:
    """Centroid id + int8 residual against a shared (Kc, M) codebook,
    assigned by max inner product (the router's affinity metric)."""
    m_dim = torch.as_tensor(embs).shape[-1]
    cb_shape = tuple(torch.as_tensor(codebook).shape)
    if len(cb_shape) != 2 or cb_shape[0] < 1 or cb_shape[1] != m_dim:
        raise ValueError(f"codebook must be (Kc, M={m_dim}); "
                         f"got {cb_shape}")
    return _encode(embs, scale_dtype, device, codebook=codebook)


def quantize(embs, fmt: str, codebook=None, scale_dtype=torch.bfloat16,
             device=None):
    """Encode ``embs`` into ``fmt`` ('bf16' passes through unchanged)."""
    if fmt == "bf16":
        return embs
    if fmt == "int8":
        return quantize_int8(embs, scale_dtype=scale_dtype, device=device)
    if fmt == "residual":
        if codebook is None:
            raise ValueError("residual format needs a (Kc, M) codebook "
                             "(the stage-1 router centroids)")
        return quantize_residual(embs, codebook, scale_dtype=scale_dtype,
                                 device=device)
    raise ValueError(f"unknown corpus format {fmt!r}; "
                     f"expected one of {CORPUS_FORMATS}")


# ---------------------------------------------------------------------------
# dequantization: the arithmetic every _q kernel runs per element
# ---------------------------------------------------------------------------

def dequant_block(data, scales, codes=None, codebook=None) -> torch.Tensor:
    """f32 rows from quantized operands: data * scale, then + codebook[code]
    for the residual format, each step rounded to f32 (the kernels'
    ``__fmul_rn`` / ``__fadd_rn``). The codebook is gathered by index."""
    out = data.to(torch.float32) * scales.to(torch.float32)[..., None]
    if codes is not None:
        out = out + codebook.to(torch.float32)[codes.long()]
    return out


def dequantize(qt: QuantTokens) -> torch.Tensor:
    """Whole-tensor f32 reconstruction."""
    return dequant_block(qt.data, qt.scales, qt.codes, qt.codebook)


def dense_rows(doc_embs) -> torch.Tensor:
    """f32 rows of either corpus kind (the plain versions' reconstruction)."""
    if isinstance(doc_embs, QuantTokens):
        return dequantize(doc_embs)
    return doc_embs.to(torch.float32)


# ---------------------------------------------------------------------------
# structural helpers: treat (tensor | QuantTokens) alike at call sites
# ---------------------------------------------------------------------------

def _take(a: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    axis = axis % a.dim()
    out = a.index_select(axis, idx.reshape(-1))
    return out.reshape(*a.shape[:axis], *idx.shape, *a.shape[axis + 1:])


def corpus_take(x, idx, axis: int = 0):
    """``jnp.take`` over one axis of a corpus operand; the codebook is
    shared state, never gathered."""
    if isinstance(x, QuantTokens):
        return QuantTokens(
            data=_take(x.data, idx, axis), scales=_take(x.scales, idx, axis),
            codes=None if x.codes is None else _take(x.codes, idx, axis),
            codebook=x.codebook)
    return _take(x, idx, axis)


def corpus_reshape(x, *lead: int):
    """Reshape the leading (doc/batch) axes to ``lead``, keeping each
    leaf's trailing dims: data (..., L, M), scales/codes (..., L)."""
    if isinstance(x, QuantTokens):
        l_dim, m_dim = x.data.shape[-2:]
        return QuantTokens(
            data=x.data.reshape(*lead, l_dim, m_dim),
            scales=x.scales.reshape(*lead, l_dim),
            codes=None if x.codes is None else x.codes.reshape(*lead, l_dim),
            codebook=x.codebook)
    return x.reshape(*lead, *x.shape[-2:])


def corpus_index(x, idx):
    """``x[idx]`` over the leading axis (codebook untouched)."""
    if isinstance(x, QuantTokens):
        return QuantTokens(
            data=x.data[idx], scales=x.scales[idx],
            codes=None if x.codes is None else x.codes[idx],
            codebook=x.codebook)
    return x[idx]
