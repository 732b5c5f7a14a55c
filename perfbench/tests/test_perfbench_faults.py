"""A whole run on the CPU at a tiny size, past the harness's look for a
card: sound, it comes out correct; with the timed path broken underneath,
or with the control (the reference in a lower precision) in the program's
place, ``correct`` comes out false."""
import time

import numpy as np
import pytest
import torch

from conftest import SEED, shrink
from perfbench import run as bench
from perfbench.harness import spec
from perfbench.reference.maxsim import candidate_scores

CPU = torch.device("cpu")


def _run(name, fault=None, seconds=2.0):
    cell = shrink(spec.cell(name))
    if "rate_per_s" in cell.traffic:
        cell.traffic["rate_per_s"] = 6.0
    if "lead_s" in cell.traffic:
        cell.traffic["lead_s"] = 1.0
    return bench.serve_window(cell, SEED, seconds, False, CPU,
                              time.perf_counter(), fault=fault)


def _correct(run, answers=None):
    nums = bench.check_run(run, SEED, answers)
    return bench.report(run, nums, False, "cpu")


def half_batch_dropped(served):
    """Half of each batch's answers never leave the engine."""
    eng = served.engine
    finish = eng._finish_batch

    def dropped(prep, out):
        comps = finish(prep, out)
        return comps[:(len(comps) + 1) // 2]

    eng._finish_batch = dropped


def answers_altered(served):
    """Each answer carries its batch neighbour's documents and scores."""
    eng = served.engine
    finish = eng._finish_batch

    def altered(prep, out):
        comps = finish(prep, out)
        n = len(comps)
        shifted = [(comps[(i + 1) % n].topk_ids, comps[(i + 1) % n].topk_scores)
                   for i in range(n)]
        for c, (ids, sc) in zip(comps, shifted):
            c.topk_ids, c.topk_scores = ids, sc
        return comps

    eng._finish_batch = altered


def state_unchanged(served):
    """The bandit returns after its first trip: nothing past the first
    reveal changes its state."""
    eng = served.engine
    dispatch = eng._dispatch_batch

    def stuck(prep):
        return dispatch(prep._replace(args=prep.args[:-1] + (1,)))

    eng._dispatch_batch = stuck


def topk_wrong(served):
    """The top-k picks the wrong documents: each answer is the k lowest
    of its candidates, each with its exact score."""
    eng, inp = served.engine, served.inputs
    finish = eng._finish_batch

    def lowest(prep, out):
        comps = finish(prep, out)
        cand = {q.rid: q for q in prep.real}
        for c in comps:
            q = cand[c.rid]
            ids = torch.as_tensor(q.cand_ids, dtype=torch.long)[None]
            sc = candidate_scores(inp.corpus.embs, inp.corpus.mask,
                                  torch.as_tensor(q.query)[None], ids)[0]
            low = torch.argsort(sc)[:len(c.topk_ids)]
            c.topk_ids = ids[0, low].numpy().astype(c.topk_ids.dtype)
            c.topk_scores = sc[low].numpy().astype(c.topk_scores.dtype)
        return comps

    eng._finish_batch = lowest


def stage1_corrupted(served):
    """Stage 1 returns documents drawn at random from the corpus, not the
    nearest ones; the rest of the path runs as it should."""
    eng = served.engine
    stage1 = eng._stage1
    C = served.inputs.corpus.embs.shape[0]
    rng = np.random.default_rng(0)

    def drawn(tb, queries):
        out = list(stage1(tb, queries))
        ids = out[0]
        out[0] = np.stack([rng.permutation(C)[:ids.shape[1]]
                           for _ in range(ids.shape[0])]).astype(ids.dtype)
        return tuple(out)

    eng._stage1 = drawn


def one_slot_in_four(served):
    """One answer in four comes out of its slot with its scores moved by
    1e-3; the other three are sound."""
    eng = served.engine
    finish = eng._finish_batch

    def moved(prep, out):
        comps = finish(prep, out)
        for c in comps[::4]:
            c.topk_scores = c.topk_scores + np.float32(1e-3)
        return comps

    eng._finish_batch = moved


CELLS = ["text-bandit-256", "text-stage1-open", "text-dense-64"]
WITH_LIST = ["text-bandit-256", "text-dense-64"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = _correct(_run(name))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name,fault,number", [
    (n, f, None) for n in CELLS for f in (half_batch_dropped, answers_altered)]
    + [(n, one_slot_in_four, "score_off_share") for n in CELLS]
    + [(n, state_unchanged, None) for n in CELLS if n != "text-dense-64"]
    + [(n, topk_wrong, "overlap_deficit") for n in WITH_LIST]
    + [("text-stage1-open", stage1_corrupted, "stage1_miss")])
def test_broken_timed_path_is_not_correct(name, fault, number, monkeypatch):
    monkeypatch.setattr(bench, "ANSWER_GRACE_S", 3.0)
    out = _correct(_run(name, fault))
    assert not out["correct"], out["checks"]
    if number is not None:
        assert out["checks"][number]["value"] > \
            out["checks"][number]["limit"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_in_lower_precision_is_not_correct(name):
    run = _run(name)
    out = _correct(run, bench.control_answers(run, "bf16"))
    assert not out["correct"], out["checks"]
    assert out["checks"]["score_gap_p50"]["value"] > \
        out["checks"]["score_gap_p50"]["limit"]
