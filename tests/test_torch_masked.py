"""The port's tile-masked MaxSim and score ops against the JAX package on
the CPU.

``repro_torch.kernels.ops.masked_maxsim_op`` and ``maxsim_scores_op`` run
on CPU tensors (their plain versions); JAX's ops of the same names run in
their plain lane (``REPRO_KERNEL_IMPL=ref``), on the same numpy inputs.
Tolerance rtol=1e-5, atol=1e-6: the two frameworks sum each M-term dot
product in different orders, both in float32; bf16 inputs are rounded
alike and upcast exactly, and int8/residual corpora come from each
package's own encoder, which are bit-equal. Inactive tiles must be exactly
0.0 and active tiles of all-masked docs exactly -3e38 in both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import quant as jq
from repro_torch.kernels import _build, ops
from repro_torch.kernels import quant as tq
from repro_torch.kernels.masked_maxsim import masked_maxsim_cuda, \
    masked_maxsim_q_cuda
from test_torch_threads import cap_torch_threads

cap_torch_threads()

RTOL, ATOL = 1e-5, 1e-6
NEG = float(np.float32(-3e38))
FORMATS = ("f32", "bf16", "int8", "residual")
# (N, L, M, T): tests/test_kernels.py SHAPES[:3], then its ODD_SHAPES.
SHAPES = [(8, 64, 128, 32), (20, 300, 128, 32), (7, 96, 128, 13),
          (13, 37, 128, 11), (7, 129, 128, 5), (9, 63, 128, 17)]


@pytest.fixture
def ref_lane(monkeypatch):
    """JAX's ops take their plain (``ref``) lane for the test."""
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "ref")


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _inputs(fmt, N, L, M, T, seed, dead=()):
    """The same corpus, token mask and queries for both frameworks:
    ((jax corpus, mask, queries), (torch corpus, mask, queries), rng).
    Doc and query rows are unit-norm, as served."""
    rng = np.random.default_rng(seed)
    x = _unit(rng.standard_normal((N, L, M))).astype(np.float32)
    lens = rng.integers(1, L + 1, N)
    mask = np.arange(L)[None, :] < lens[:, None]
    mask[list(dead)] = False
    q = _unit(rng.standard_normal((T, M))).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jqq, tqq = jnp.asarray(q), torch.from_numpy(q)
    if fmt == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
        jqq, tqq = jqq.astype(jnp.bfloat16), tqq.to(torch.bfloat16)
    elif fmt in ("int8", "residual"):
        cb = (_unit(rng.standard_normal((6, M))).astype(np.float32)
              if fmt == "residual" else None)
        jx = jq.quantize(x, fmt, codebook=cb)
        tx = tq.quantize(tx, fmt,
                         codebook=None if cb is None else torch.from_numpy(cb))
    return ((jx, jnp.asarray(mask), jqq),
            (tx, torch.from_numpy(mask), tqq), rng)


def _grid(N, T, bn, bt):
    return -(-N // bn), -(-T // bt)


def _full(tm: np.ndarray, bn, bt, N, T) -> np.ndarray:
    return np.repeat(np.repeat(tm, bn, 0), bt, 1)[:N, :T]


def _both(jargs, targs, tm, bn, bt):
    """(port's H as numpy, JAX's H as numpy) for one tile mask."""
    want = jops.masked_maxsim_op(*jargs, jnp.asarray(tm), block_n=bn,
                                 block_t=bt)
    got = ops.masked_maxsim_op(*targs, torch.from_numpy(tm), block_n=bn,
                               block_t=bt)
    assert got.dtype == torch.float32
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("block", [4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("fmt", FORMATS)
def test_masked_maxsim_op_matches_jax(ref_lane, fmt, shape, block):
    N, L, M, T = shape
    jargs, targs, rng = _inputs(fmt, N, L, M, T, seed=N * L + T)
    tm = rng.random(_grid(N, T, block, block)) < 0.6
    got, want = _both(jargs, targs, tm, block, block)
    assert got.shape == (N, T)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    full = _full(tm, block, block, N, T)
    assert (got[~full] == 0.0).all() and (want[~full] == 0.0).all()
    # Active cells are the dense op's, bit for bit (as on the card).
    dense = ops.maxsim_op(*targs).numpy()
    np.testing.assert_array_equal(got, np.where(full, dense, 0.0))


@pytest.mark.parametrize("fmt", FORMATS)
def test_all_tiles_inactive_give_exact_zeros(ref_lane, fmt):
    N, L, M, T = 16, 64, 128, 16
    jargs, targs, _ = _inputs(fmt, N, L, M, T, seed=3, dead=(5,))
    got, want = _both(jargs, targs, np.zeros((2, 2), bool), 8, 8)
    assert (got == 0.0).all() and (want == 0.0).all()


@pytest.mark.parametrize("fmt", FORMATS)
def test_all_masked_docs_in_active_and_inactive_tiles(ref_lane, fmt):
    """Doc 0's tiles are all active (-3e38 everywhere), doc 4's all
    inactive (0 everywhere), doc 10's mixed."""
    N, L, M, T = 11, 40, 128, 10
    jargs, targs, _ = _inputs(fmt, N, L, M, T, seed=13, dead=(0, 4, 10))
    tm = np.array([[True, True, True], [False, False, False],
                   [True, False, True]])
    got, want = _both(jargs, targs, tm, 4, 4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for h in (got, want):
        assert (h[0] == NEG).all() and (h[4] == 0.0).all()
        np.testing.assert_array_equal(h[10], [NEG] * 4 + [0.0] * 4 + [NEG] * 2)
        assert np.isfinite(h).all() and (h[[1, 2, 3]] > -1.0).all()


@pytest.mark.parametrize("fmt", FORMATS)
def test_maxsim_scores_op_matches_jax(ref_lane, fmt):
    """S = sum_t H; all-masked docs give -inf in both frameworks."""
    jargs, targs, _ = _inputs(fmt, 12, 40, 64, 9, seed=21, dead=(2, 7))
    want = np.asarray(jops.maxsim_scores_op(*jargs))
    got = ops.maxsim_scores_op(*targs)
    assert got.shape == (12,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert np.isneginf(want[[2, 7]]).all()
    assert np.isneginf(got.numpy()[[2, 7]]).all()


def _small():
    e = torch.zeros((5, 3, 8))
    m = torch.ones((5, 3), dtype=torch.bool)
    q = torch.zeros((7, 8))
    return e, m, q, torch.ones((2, 2), dtype=torch.bool)


@pytest.mark.parametrize("case,match", [
    ("float-mask", "bool tensor"),
    ("uint8-mask", "bool tensor"),
    ("short-mask", r"tile_mask must be \(ceil"),
    ("wide-mask", r"tile_mask must be \(ceil"),
    ("block_n-0", ">= 1"),
    ("block_t-0", ">= 1"),
    ("mixed-devices", "all be on the CPU or all on CUDA")])
def test_masked_maxsim_op_rejects_malformed_operands(case, match):
    """A malformed tile mask raises; it is never padded or cut."""
    e, m, q, tm = _small()                 # N=5, T=7: a (2, 2) grid at 4
    kw = dict(block_n=4, block_t=4)
    tm = {"float-mask": tm.float(), "uint8-mask": tm.to(torch.uint8),
          "short-mask": tm[:1], "wide-mask": torch.ones((2, 3), dtype=bool),
          "mixed-devices": tm.to("meta")}.get(case, tm)
    if case.startswith("block"):
        kw[case.split("-")[0]] = 0
    with pytest.raises(ValueError, match=match):
        ops.masked_maxsim_op(e, m, q, tm, **kw)


def test_masked_cuda_wrappers_refuse_cpu_tensors():
    """A CUDA wrapper never falls back to the plain version, and a refused
    call counts no launch."""
    e, m, q, tm = _small()
    qt = tq.quantize(torch.randn((5, 3, 8)), "int8")
    _build.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        masked_maxsim_cuda(e, m, q, tm, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        masked_maxsim_q_cuda(qt, m, q, tm, 4, 4)
    with pytest.raises(ValueError, match="QuantTokens"):
        masked_maxsim_cuda(qt, m, q, tm, 4, 4)
    with pytest.raises(ValueError, match="QuantTokens"):
        masked_maxsim_q_cuda(e, m, q, tm, 4, 4)
    with pytest.raises(ValueError, match="tile_mask must be"):
        masked_maxsim_cuda(e, m, q, tm, 8, 4)
    assert not any(_build.LAUNCHES.values())
