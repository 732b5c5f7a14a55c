"""Plain PyTorch versions of the ported kernels against the JAX package's
oracles (``repro.kernels.ref``), on the CPU, plus the dispatch contract of
``repro_torch.kernels.ops``.

Tolerance rtol=1e-5, atol=1e-6 in float32: XLA and PyTorch sum each M-term
dot product in different orders, both accumulating in float32. bf16 inputs
are rounded identically by both frameworks and upcast exactly, so they keep
the same tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import ops
from repro_torch.kernels.gather_maxsim import gather_maxsim_cuda, \
    gather_maxsim_plain
from repro_torch.kernels.maxsim import maxsim_batch_cuda, \
    maxsim_batch_plain, maxsim_plain
from repro_torch.kernels.reveal import fused_reveal_cuda, \
    fused_reveal_plain, reveal_stats
from test_torch_threads import cap_torch_threads

cap_torch_threads()

RTOL, ATOL = 1e-5, 1e-6

# (label, L, all-masked docs, bf16 inputs)
CASES = [("random", 16, (), False), ("odd-L", 13, (), False),
         ("all-masked", 16, (0, 2), False), ("bf16", 16, (), True)]


def _docs(seed, n_docs, L, M, dead):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n_docs, L, M)).astype(np.float32)
    lens = rng.integers(1, L + 1, n_docs)
    mask = np.arange(L)[None, :] < lens[:, None]
    mask[list(dead)] = False
    return e, mask, rng


def _pair(x, bf16):
    """The same array for both frameworks (bf16-rounded alike if asked)."""
    if bf16:
        return jnp.asarray(x).astype(jnp.bfloat16), \
            torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("label,L,dead,bf16", CASES)
def test_maxsim_plain_matches_ref(label, L, dead, bf16):
    e, m, rng = _docs(0, 12, L, 32, dead)
    q = rng.standard_normal((9, 32)).astype(np.float32)
    (je, te), (jq, tq) = _pair(e, bf16), _pair(q, bf16)
    want = ref.maxsim_ref(je, jnp.asarray(m), jq)
    tm = torch.from_numpy(m)
    _close(maxsim_plain(te, tm, tq), want)
    _close(ops.maxsim_op(te, tm, tq), want)


@pytest.mark.parametrize("label,L,dead,bf16", CASES)
def test_maxsim_batch_plain_matches_ref(label, L, dead, bf16):
    e, m, rng = _docs(1, 3 * 10, L, 32, dead)
    e, m = e.reshape(3, 10, L, 32), m.reshape(3, 10, L)
    q = rng.standard_normal((3, 7, 32)).astype(np.float32)
    (je, te), (jq, tq) = _pair(e, bf16), _pair(q, bf16)
    want = ref.maxsim_batch_ref(je, jnp.asarray(m), jq, block_l=8)
    tm = torch.from_numpy(m)
    _close(maxsim_batch_plain(te, tm, tq, block_l=5), want)
    _close(ops.maxsim_batch_op(te, tm, tq), want)


def _selection(rng, F, G, D, TQ):
    doc_idx = rng.integers(0, D, F)
    doc_idx[:3] = [0, 2, 0]          # all-masked docs in the masked case
    return doc_idx, rng.integers(0, TQ, (F, G))


@pytest.mark.parametrize("label,L,dead,bf16", CASES)
def test_gather_maxsim_plain_matches_ref(label, L, dead, bf16):
    e, m, rng = _docs(2, 20, L, 24, dead)
    q = rng.standard_normal((16, 24)).astype(np.float32)
    di, ti = _selection(rng, 11, 4, 20, 16)
    (je, te), (jq, tq) = _pair(e, bf16), _pair(q, bf16)
    want = ref.gather_maxsim_ref(je, jnp.asarray(m), jq, jnp.asarray(di),
                                 jnp.asarray(ti))
    args = (te, torch.from_numpy(m), tq, torch.from_numpy(di),
            torch.from_numpy(ti))
    _close(gather_maxsim_plain(*args), want)
    _close(ops.gather_maxsim_op(*args), want)


@pytest.mark.parametrize("fresh", ["random", "none"])
@pytest.mark.parametrize("label,L,dead,bf16", CASES)
def test_fused_reveal_plain_matches_ref(label, L, dead, bf16, fresh):
    e, m, rng = _docs(3, 20, L, 24, dead)
    q = rng.standard_normal((16, 24)).astype(np.float32)
    di, ti = _selection(rng, 11, 5, 20, 16)
    new = (rng.random((11, 5)) < 0.6 if fresh == "random"
           else np.zeros((11, 5), bool))
    new[:3] = False      # all-masked docs are never fresh on the serving path
    (je, te), (jq, tq) = _pair(e, bf16), _pair(q, bf16)
    want_v, want_s = ref.fused_reveal_ref(
        je, jnp.asarray(m), jq, jnp.asarray(di), jnp.asarray(ti),
        jnp.asarray(new))
    args = (te, torch.from_numpy(m), tq, torch.from_numpy(di),
            torch.from_numpy(ti), torch.from_numpy(new))
    for vals, stats in (fused_reveal_plain(*args), ops.fused_reveal_op(*args)):
        _close(vals, want_v)
        _close(stats, want_s)
        assert stats.shape == (11, 3)


def test_reveal_stats_sums_serially_in_ascending_g():
    """The statistics are the kernel's serial float32 sums, bit for bit."""
    rng = np.random.default_rng(4)
    vals = rng.standard_normal((6, 9)).astype(np.float32) * 10
    new = rng.random((6, 9)) < 0.5
    got = reveal_stats(torch.from_numpy(vals), torch.from_numpy(new)).numpy()
    for f in range(6):
        cnt = tot = sq = np.float32(0)
        for g in range(9):
            vm = vals[f, g] if new[f, g] else np.float32(0)
            cnt = np.float32(cnt + np.float32(new[f, g]))
            tot = np.float32(tot + vm)
            sq = np.float32(sq + np.float32(vm * vals[f, g]))
        np.testing.assert_array_equal(got[f], [cnt, tot, sq])


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CUDA wrapper never falls back to the plain version."""
    e = torch.zeros((4, 3, 8))
    m = torch.ones((4, 3), dtype=torch.bool)
    q = torch.zeros((5, 8))
    di = torch.zeros((2,), dtype=torch.int64)
    ti = torch.zeros((2, 2), dtype=torch.int64)
    nm = torch.ones((2, 2), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        maxsim_batch_cuda(e[None], m[None], q[None])
    with pytest.raises(ValueError, match="CUDA"):
        gather_maxsim_cuda(e, m, q, di, ti)
    with pytest.raises(ValueError, match="CUDA"):
        fused_reveal_cuda(e, m, q, di, ti, nm)


def test_ops_reject_mixed_devices_and_row_mismatch():
    e = torch.zeros((4, 3, 8))
    m = torch.ones((4, 3), dtype=torch.bool)
    q = torch.zeros((5, 8), device="meta")
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        ops.maxsim_op(e, m, q)
    q = torch.zeros((5, 8))
    di = torch.zeros((3,), dtype=torch.int64)
    ti = torch.zeros((2, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="rows"):
        ops.gather_maxsim_op(e, m, q, di, ti)
    with pytest.raises(ValueError, match="disagree"):
        ops.fused_reveal_op(e, m, q, di, ti, torch.ones((2, 2), dtype=bool))
