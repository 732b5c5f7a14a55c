"""Arithmetic the metric readers share (each reader is its own file under
``metrics/``, named as its metric)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from perfbench.reference import roofline


def reveal_fraction(run) -> Optional[float]:
    fr = [c.reveal_fraction for c in run.completions()]
    return float(np.mean(fr)) if fr else None


def idle_pct(run) -> Optional[float]:
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def _request_work(run, r, kind: str):
    """(bytes, flops) request ``r`` needed of the reveal kernels
    (``"reveal"``), of the dense kernel (``"dense"``), or of the whole step
    (``"step"``: stage 1 where the cell runs it, plus the revealed or dense
    cells)."""
    T, M, slots = run.dims
    c = r.completion
    tok = run.cand_tokens(r)
    if kind == "reveal" or (kind == "step" and c.flavor == "bandit"):
        b, f = roofline.request_reveal(tok, run.n_cand(), T, M,
                                       c.reveal_fraction,
                                       int(run.cell.traffic["k"]))
    else:
        b, f = roofline.request_dense(tok, run.n_cand(), T, M)
    if kind == "step" and run.inputs.cands is None:
        f += roofline.stage1_flops(slots, T, M)
    return b, f


def kernel_roofline_pct(run, kind: str, *kernel: str) -> Optional[float]:
    """The bound of the work of the steps that ran whole inside the
    profile, over the device seconds of the kernels named ``kernel`` that
    those same steps launched. A step counts only if every request of its
    batch was sent in the window and none of its kernel records was lost."""
    tr = run.trace
    if tr is None:
        return None
    by_rid = {r.completion.rid: r for r in run.records if r.ok}
    bound = k_s = 0.0
    for sp in tr.whole_steps():
        recs = [by_rid.get(rid) for rid in sp[5]]
        if not recs or any(r is None for r in recs):
            continue
        work = [_request_work(run, r, kind) for r in recs]
        bound += roofline.bound_s(sum(w[0] for w in work),
                                  sum(w[1] for w in work))[0]
        k_s += tr.step_kernel_s(sp, *kernel)
    if k_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / k_s


def mfu_pct(run) -> Optional[float]:
    flops = sum(_request_work(run, r, "step")[1]
                for r in run.completed_in_window())
    if flops <= 0:
        return None
    return 100.0 * flops / (run.seconds * roofline.PEAK_F32_FLOPS)
