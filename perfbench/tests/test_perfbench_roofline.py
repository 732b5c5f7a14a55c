"""The frozen bound arithmetic reproduces the bounds PERF.md gives at the
phase-3 shapes of ``chip_smoke.py`` (lengths uniform over 32..128, so 80
valid tokens a doc on average; the card's draw gave 0.0513 ms and
0.00162 ms)."""
import math

import pytest

from perfbench.reference import roofline


def test_maxsim_slice_bound():
    B, N, L, T, M = 16, 256, 128, 32, 128
    valid = (B * N - 1) * 80            # one doc of the draw is all masked
    nbytes, flops = roofline.maxsim_launch(valid, B, N, L, T, M)
    s, by = roofline.bound_s(nbytes, flops)
    assert by == "bytes"
    assert s * 1e3 == pytest.approx(0.0513, rel=0.03)


def test_fused_reveal_round_bound():
    F, G, L, M, D, TQ = 128, 8, 128, 128, 16 * 256, 16 * 32
    docs_u = F * (1 - 1 / D) ** 0 - 1          # 127 live docs, one dead
    valid_u = docs_u * 80
    toks_u = TQ * (1 - math.exp(-F * G / TQ))   # distinct query rows drawn
    nbytes, flops = roofline.reveal_launch(valid_u, valid_u, docs_u + 1,
                                           toks_u, F, G, L, M)
    s, by = roofline.bound_s(nbytes, flops)
    assert by == "bytes"
    assert s * 1e3 == pytest.approx(0.00162, rel=0.03)


def test_request_work_counts():
    # 2 docs of 10 and 20 tokens, T = 4, M = 8, half the cells revealed
    b, f = roofline.request_reveal(30, 2, 4, 8, 0.5, k=5)
    assert b == 30 * 8 * 4 + 2 + 4 * 8 * 4 + 5 * 8
    assert f == 0.5 * 4 * 2 * 8 * 30
    b, f = roofline.request_dense(30, 2, 4, 8)
    assert f == 4 * 2 * 8 * 30 and b == 30 * 32 + 2 + 128 + 2 * 4 * 4
    assert roofline.stage1_flops(1000, 4, 8) == 2 * 4 * 1000 * 8
