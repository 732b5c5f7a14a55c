"""The port's compressed-corpus formats (``repro_torch.kernels.quant``) and
the plain kernel versions on a ``QuantTokens`` corpus, against the JAX
package on the CPU.

Encoders, ``dequantize`` and the structural helpers must be bit-equal to
``repro.kernels.quant``: the same int8 payload, the same bf16 scale bits,
the same centroid codes. The plain MaxSim versions on a quantized corpus
match JAX's ``kernels/ref.py`` oracles at rtol=1e-5, atol=1e-6 (the two
frameworks sum each M-term dot in different orders, both in float32) and
the port's own plain version on the dequantized twin bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import quant as jq
from repro.kernels import ref
from repro_torch.kernels import _build, ops
from repro_torch.kernels import quant as tq
from repro_torch.kernels.gather_maxsim import gather_maxsim_plain, \
    gather_maxsim_q_cuda
from repro_torch.kernels.maxsim import maxsim_batch_plain, \
    maxsim_batch_q_cuda, maxsim_plain
from repro_torch.kernels.reveal import fused_reveal_plain, \
    fused_reveal_q_cuda, reveal_stats
from test_torch_threads import cap_torch_threads

cap_torch_threads()

RTOL, ATOL = 1e-5, 1e-6
FORMATS = ("int8", "residual")


def _rows(N, L, M, seed=0, unit=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, L, M)).astype(np.float32)
    if unit:
        x /= np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)
    return x


def _codebook(M, Kc=4, seed=1):
    cb = np.random.default_rng(seed).standard_normal((Kc, M))
    cb /= np.linalg.norm(cb, axis=-1, keepdims=True)
    return cb.astype(np.float32)


def _bits(x):
    """Raw bits of a tensor or array (bf16 viewed as int16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        return x.view(np.int16)
    return x


def _assert_same_quant(got: tq.QuantTokens, want: jq.QuantTokens):
    assert got.fmt == want.fmt
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(_bits(g), _bits(w))
            assert _bits(g).dtype == _bits(w).dtype


def _encode_both(x, fmt, cb=None, scale_dtype="bf16"):
    jdt = jnp.bfloat16 if scale_dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if scale_dtype == "bf16" else torch.float32
    want = jq.quantize(x, fmt, codebook=cb, scale_dtype=jdt)
    got = tq.quantize(torch.from_numpy(x), fmt,
                      codebook=None if cb is None else torch.from_numpy(cb),
                      scale_dtype=tdt)
    return got, want


# ---------------------------------------------------------------------------
# encoders: bit for bit
# ---------------------------------------------------------------------------

@given(st.integers(1, 12), st.integers(1, 9), st.integers(1, 32),
       st.integers(0, 1000))
@settings(max_examples=20, deadline=None)
def test_int8_encoder_is_bit_equal_over_magnitudes(N, L, M, seed):
    """Rows at 1e-3 .. 1e3 per row, an all-zero row and a near-f32-overflow
    row encode to JAX's payload and scale bits."""
    rng = np.random.default_rng(seed)
    x = _rows(N, L, M, seed, unit=False)
    x *= 10.0 ** rng.integers(-3, 4, (N, L, 1)).astype(np.float32)
    x[0, 0] = 0.0                              # all-zero row
    if N > 1 or L > 1:                         # distinct near-overflow row
        x[-1, -1] = rng.standard_normal(M).astype(np.float32) * 1e36
    got, want = _encode_both(x, "int8")
    _assert_same_quant(got, want)
    assert (tq.dequantize(got)[0, 0] == 0).all()


@given(st.integers(1, 10), st.integers(1, 8), st.integers(2, 24),
       st.integers(0, 1000))
@settings(max_examples=20, deadline=None)
def test_residual_encoder_is_bit_equal(N, L, M, seed):
    x = _rows(N, L, M, seed)
    cb = _codebook(M, seed=seed + 1)
    x[0, 0] = cb[2]                            # residual exactly zero
    got, want = _encode_both(x, "residual", cb)
    _assert_same_quant(got, want)
    assert int(got.codes[0, 0]) == 2 and got.codes.dtype == torch.int32


@pytest.mark.parametrize("fmt", FORMATS)
def test_f32_scales_and_chunked_encoding_are_bit_equal(fmt, monkeypatch):
    """``scale_dtype=float32`` and an encode split into many doc chunks
    give JAX's whole-array result."""
    x = _rows(9, 5, 16, seed=3, unit=False)
    cb = _codebook(16, Kc=3) if fmt == "residual" else None
    monkeypatch.setattr(tq, "_CHUNK_ELEMS", 2 * 5 * 16)
    got, want = _encode_both(x, fmt, cb, scale_dtype="f32")
    assert got.scales.dtype == torch.float32
    _assert_same_quant(got, want)


def test_encoder_guards_raise():
    x = _rows(2, 3, 8)
    with pytest.raises(ValueError, match="codebook must be"):
        tq.quantize_residual(torch.from_numpy(x), torch.zeros((4, 7)))
    with pytest.raises(ValueError, match="codebook must be"):
        tq.quantize_residual(torch.from_numpy(x), torch.zeros((0, 8)))
    with pytest.raises(ValueError, match="needs a"):
        tq.quantize(torch.from_numpy(x), "residual")
    with pytest.raises(ValueError, match="unknown corpus format"):
        tq.quantize(torch.from_numpy(x), "fp4")
    with pytest.raises(ValueError, match="unknown corpus format"):
        tq.format_ordinal("fp4")
    assert tq.quantize(x, "bf16") is x
    for fmt in tq.CORPUS_FORMATS:
        assert tq.format_ordinal(fmt) == jq.format_ordinal(fmt)


# ---------------------------------------------------------------------------
# dequantize and the structural helpers: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_dequantize_and_helpers_are_bit_equal(fmt):
    x = _rows(10, 6, 16, seed=4, unit=False)
    cb = _codebook(16, Kc=5) if fmt == "residual" else None
    got, want = _encode_both(x, fmt, cb)
    np.testing.assert_array_equal(tq.dequantize(got).numpy(),
                                  np.asarray(jq.dequantize(want)))
    assert tq.corpus_nbytes(got) == jq.corpus_nbytes(want)
    assert tq.corpus_nbytes(torch.from_numpy(x)) == jq.corpus_nbytes(x)
    assert tq.corpus_format(got) == fmt
    assert tq.corpus_format(torch.from_numpy(x)) == "bf16"
    idx = np.array([[3, 0, 9], [1, 1, 4]])
    _assert_same_quant(tq.corpus_take(got, torch.from_numpy(idx)),
                       jq.corpus_take(want, jnp.asarray(idx)))
    _assert_same_quant(tq.corpus_reshape(got, 2, 5),
                       jq.corpus_reshape(want, 2, 5))
    _assert_same_quant(tq.corpus_index(got, torch.tensor([4, 2])),
                       jq.corpus_index(want, jnp.asarray([4, 2])))
    assert len(tq.corpus_leaves(got)) == len(jq.corpus_leaves(want))
    assert got.shape == want.shape and got.ndim == want.ndim == 3
    assert got.dtype == torch.int8
    assert tq.QuantTokens(*got.to("cpu")).fmt == fmt


# ---------------------------------------------------------------------------
# plain kernel versions on a QuantTokens corpus
# ---------------------------------------------------------------------------

def _corpus(fmt, n_docs, L, M, seed, dead=(0,)):
    """A quantized corpus for both frameworks, its f32 twin, and a mask
    with ragged lengths and all-masked docs."""
    rng = np.random.default_rng(seed)
    x = _rows(n_docs, L, M, seed)
    cb = _codebook(M, Kc=6, seed=seed + 2) if fmt == "residual" else None
    got, want = _encode_both(x, fmt, cb)
    lens = rng.integers(1, L + 1, n_docs)
    mask = np.arange(L)[None, :] < lens[:, None]
    mask[list(dead)] = False
    return got, want, mask, rng


@pytest.mark.parametrize("fmt", FORMATS)
def test_maxsim_plain_on_quantized_matches_ref(fmt):
    got, want, mask, rng = _corpus(fmt, 7, 37, 24, seed=5)
    q = rng.standard_normal((9, 24)).astype(np.float32)
    jw = ref.maxsim_ref(want, jnp.asarray(mask), jnp.asarray(q))
    tm, tqq = torch.from_numpy(mask), torch.from_numpy(q)
    h = maxsim_plain(got, tm, tqq)
    np.testing.assert_allclose(h.numpy(), np.asarray(jw), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(h, maxsim_plain(tq.dequantize(got), tm, tqq))
    assert torch.equal(ops.maxsim_op(got, tm, tqq), h)


@pytest.mark.parametrize("fmt", FORMATS)
def test_maxsim_batch_plain_on_quantized_matches_ref(fmt):
    got, want, mask, rng = _corpus(fmt, 3 * 5, 37, 24, seed=6, dead=(0, 7))
    got = tq.corpus_reshape(got, 3, 5)
    want = jq.corpus_reshape(want, 3, 5)
    mask = mask.reshape(3, 5, 37)
    q = rng.standard_normal((3, 7, 24)).astype(np.float32)
    jw = ref.maxsim_batch_ref(want, jnp.asarray(mask), jnp.asarray(q),
                              block_l=16)
    tm, tqq = torch.from_numpy(mask), torch.from_numpy(q)
    h = maxsim_batch_plain(got, tm, tqq, block_l=16)
    np.testing.assert_allclose(h.numpy(), np.asarray(jw), rtol=RTOL,
                               atol=ATOL)
    assert float(h[0, 0].max()) == float(np.float32(-3e38))
    assert torch.equal(h, maxsim_batch_plain(tq.dequantize(got), tm, tqq,
                                             block_l=16))
    assert torch.equal(ops.maxsim_batch_op(got, tm, tqq),
                       maxsim_batch_plain(got, tm, tqq))


@pytest.mark.parametrize("fmt", FORMATS)
def test_gathered_plain_versions_on_quantized_match_ref(fmt):
    got, want, mask, rng = _corpus(fmt, 20, 37, 24, seed=7, dead=(0, 2))
    q = rng.standard_normal((16, 24)).astype(np.float32)
    F, G = 13, 5                                 # odd F
    di = rng.integers(0, 20, F)
    di[:3] = [0, 2, 0]                           # all-masked docs
    ti = rng.integers(0, 16, (F, G))
    new = rng.random((F, G)) < 0.6
    new[:3] = False
    jv, js = ref.fused_reveal_ref(want, jnp.asarray(mask), jnp.asarray(q),
                                  jnp.asarray(di), jnp.asarray(ti),
                                  jnp.asarray(new))
    args = (torch.from_numpy(mask), torch.from_numpy(q),
            torch.from_numpy(di), torch.from_numpy(ti))
    vals = gather_maxsim_plain(got, *args)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(vals, gather_maxsim_plain(tq.dequantize(got), *args))
    assert torch.equal(ops.gather_maxsim_op(got, *args), vals)
    for fv, fs in (fused_reveal_plain(got, *args, torch.from_numpy(new)),
                   ops.fused_reveal_op(got, *args, torch.from_numpy(new))):
        assert torch.equal(fv, vals)
        np.testing.assert_allclose(fs.numpy(), np.asarray(js), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("fmt", ["f32", "residual"])
def test_plain_versions_match_ref_at_96_query_rows_and_a_large_codebook(fmt):
    """G = 96 query rows per frontier row (the kernels run two chunks of
    64) and a Kc = 512 codebook (too large for the kernels to stage, read
    from global memory): the plain versions, which the card's kernels are
    held to, equal JAX's ref lane within tolerance, and the stats keep
    their serial order (fused stats == reveal_stats of the values)."""
    rng = np.random.default_rng(21)
    n_docs, L, M, TQ, F, G = 12, 20, 16, 128, 5, 96
    x = _rows(n_docs, L, M, seed=21)
    if fmt == "residual":
        got, want = _encode_both(x, fmt, _codebook(M, Kc=512, seed=22))
        assert got.codebook.shape == (512, M)
    else:
        got, want = torch.from_numpy(x), jnp.asarray(x)
    lens = rng.integers(1, L + 1, n_docs)
    mask = np.arange(L)[None, :] < lens[:, None]
    mask[0] = False
    q = rng.standard_normal((TQ, M)).astype(np.float32)
    di = rng.integers(0, n_docs, F)
    di[0] = 0
    ti = rng.integers(0, TQ, (F, G))
    new = rng.random((F, G)) < 0.6
    jv, js = ref.fused_reveal_ref(want, jnp.asarray(mask), jnp.asarray(q),
                                  jnp.asarray(di), jnp.asarray(ti),
                                  jnp.asarray(new))
    args = (torch.from_numpy(mask), torch.from_numpy(q),
            torch.from_numpy(di), torch.from_numpy(ti))
    vals, stats = fused_reveal_plain(got, *args, torch.from_numpy(new))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(stats.numpy(), np.asarray(js), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(stats, reveal_stats(vals, torch.from_numpy(new)))
    assert torch.equal(gather_maxsim_plain(got, *args), vals)
    B, N = 3, 4
    qb = rng.standard_normal((B, G, M)).astype(np.float32)
    if fmt == "residual":
        gb, wb = tq.corpus_reshape(got, B, N), jq.corpus_reshape(want, B, N)
    else:
        gb, wb = got.reshape(B, N, L, M), want.reshape(B, N, L, M)
    jh = ref.maxsim_batch_ref(wb, jnp.asarray(mask.reshape(B, N, L)),
                              jnp.asarray(qb), block_l=8)
    h = maxsim_batch_plain(gb, torch.from_numpy(mask.reshape(B, N, L)),
                           torch.from_numpy(qb), block_l=8)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# dispatch and the _q wrappers' contract (CPU side)
# ---------------------------------------------------------------------------

def _small_quant(fmt):
    x = _rows(4, 3, 8)
    cb = _codebook(8, Kc=2) if fmt == "residual" else None
    return tq.quantize(torch.from_numpy(x), fmt,
                       codebook=None if cb is None else torch.from_numpy(cb))


@pytest.mark.parametrize("fmt", FORMATS)
def test_q_wrappers_refuse_cpu_leaves(fmt):
    """A ``_q`` wrapper never falls back to the plain version."""
    qt = _small_quant(fmt)
    m = torch.ones((4, 3), dtype=torch.bool)
    q = torch.zeros((5, 8))
    di = torch.zeros((2,), dtype=torch.int64)
    ti = torch.zeros((2, 2), dtype=torch.int64)
    nm = torch.ones((2, 2), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        maxsim_batch_q_cuda(tq.corpus_reshape(qt, 1, 4), m[None], q[None])
    with pytest.raises(ValueError, match="CUDA"):
        gather_maxsim_q_cuda(qt, m, q, di, ti)
    with pytest.raises(ValueError, match="CUDA"):
        fused_reveal_q_cuda(qt, m, q, di, ti, nm)


def test_ops_reject_a_corpus_split_across_devices():
    qt = _small_quant("residual")
    split = qt._replace(codebook=torch.zeros((2, 8), device="meta"))
    m = torch.ones((4, 3), dtype=torch.bool)
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        ops.maxsim_op(split, m, torch.zeros((5, 8)))


@pytest.mark.parametrize("case,match", [
    ("data-float", "data must be an int8"),
    ("scales-f16", "scales must be"),
    ("scales-shape", "scales must be"),
    ("codes-alone", "come together"),
    ("codebook-alone", "come together"),
    ("codes-int64", "codes must be int32"),
    ("codebook-width", "codebook must be float32"),
    ("noncontiguous", "contiguous")])
def test_quant_args_reject_malformed_leaves(case, match):
    qt = _small_quant("residual")
    bad = {
        "data-float": qt._replace(data=qt.data.float()),
        "scales-f16": qt._replace(scales=qt.scales.half()),
        "scales-shape": qt._replace(scales=qt.scales[:, :2]),
        "codes-alone": qt._replace(codebook=None),
        "codebook-alone": qt._replace(codes=None),
        "codes-int64": qt._replace(codes=qt.codes.long()),
        "codebook-width": qt._replace(codebook=qt.codebook[:, :4]),
        "noncontiguous": qt._replace(
            scales=qt.scales.t().contiguous().t()),
    }[case]
    with pytest.raises(ValueError, match=match):
        _build.quant_args("maxsim_q", bad)


@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_args_pass_the_kernel_arguments(fmt):
    qt = _small_quant(fmt)
    args, s_bf16 = _build.quant_args("maxsim_q", qt)
    assert s_bf16 == 1 and len(args) == 5
    assert args[0] == qt.data.data_ptr()
    if fmt == "int8":
        assert args[2:] == [None, None, 0]
    else:
        assert args[2] == qt.codes.data_ptr() and args[4] == 2
