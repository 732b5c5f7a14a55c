"""The port's serving-contract audit (``repro_torch.analysis.audit`` and
``RetrievalEngine.audit`` / ``EngineConfig(audit=True)``) on the CPU,
mirroring ``tests/test_analysis_audit.py`` rule for rule; plus the index
helpers and the three ``examples/torch_*.py`` programs.

A warmed bucket is audited by running its step once on its bucket's shapes
under a ``TorchDispatchMode`` recorder. On the CPU the recorder sees
``.item()`` / ``bool()`` / ``int()`` / ``float()`` (``aten.
_local_scalar_dense``) and the data-dependent-size ops; ``.cpu()``,
``.tolist()`` and ``.numpy()`` of a CPU tensor dispatch nothing
(``test_what_the_recorder_sees_on_the_cpu`` pins this), so these tests rely
on the scalar reads alone; a copy from the card is a ``_to_copy``, checked
on the card (``test_torch_cuda.py``). In-process, no subprocess.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro.analysis.hlo_audit import \
    scorecard_budget_bytes as j_scorecard_budget_bytes
from repro.retrieval.index import build_index_from_ragged as j_from_ragged
from repro_torch.analysis import (AuditError, AuditSpec, Recorder,
                                  audit_step, note_collective,
                                  scorecard_budget_bytes)
from repro_torch.core import frontier
from repro_torch.kernels.quant import dequantize
from repro_torch.retrieval import service
from repro_torch.retrieval.index import build_index_from_ragged
from repro_torch.serve import EngineConfig, RetrievalEngine
from test_torch_threads import cap_torch_threads

cap_torch_threads()

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOOP = "core/frontier.py::run_loop"
_CFG = dict(batch_size=2, token_buckets=(8,), cand_buckets=(16,), max_k=4,
            block_docs=4, block_tokens=4)


def _toy(dtype=torch.float32, C=64, L=8, M=16, seed=0):
    rng = np.random.default_rng(seed)
    embs = rng.standard_normal((C, L, M)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=-1, keepdims=True)
    return torch.as_tensor(embs).to(dtype), np.ones((C, L), bool)


def _engine(dtype=torch.float32, **kw):
    embs, mask = _toy(dtype)
    cfg = dict(_CFG)
    cfg.update(kw)
    return RetrievalEngine(embs, mask, EngineConfig(**cfg), device="cpu")


# ---------------------------------------------------------------------------
# the recorder and the rules on crafted functions
# ---------------------------------------------------------------------------

def test_what_the_recorder_sees_on_the_cpu():
    x = torch.arange(6.0)
    seen = {}
    for name, fn in (("item", lambda: x[0].item()),
                     ("bool", lambda: bool(x.any())),
                     ("int", lambda: int(x[1])),
                     ("float", lambda: float(x.sum())),
                     ("nonzero", lambda: x.nonzero()),
                     ("bool_index", lambda: x[x > 2]),
                     ("tolist", lambda: x.tolist()),
                     ("cpu", lambda: x.cpu()),
                     ("numpy", lambda: x.numpy()),
                     ("sum", lambda: x.sum())):
        with Recorder() as rec:
            fn()
        seen[name] = len(rec.reads)
    assert seen == {"item": 1, "bool": 1, "int": 1, "float": 1,
                    "nonzero": 1, "bool_index": 1, "tolist": 0, "cpu": 0,
                    "numpy": 0, "sum": 0}


def test_rules_fire_on_crafted_steps():
    x = torch.ones(8)
    spec = AuditSpec(collective_budget=0)
    rep = audit_step(lambda: x * 2, spec, label="clean")
    assert rep.collective_total == 0 and rep.host_reads == {}
    for fn, rule in ((lambda: float(x.sum()), "hlo-host-sync"),
                     (lambda: x.double(), "hlo-f64"),
                     (lambda: note_collective("all-gather", 64),
                      "hlo-collective-budget")):
        with pytest.raises(AuditError) as ei:
            audit_step(fn, spec, label="crafted")
        assert ei.value.rule == rule and "crafted" in str(ei.value)
    audit_step(lambda: note_collective("all-gather", 64),
               AuditSpec(collective_budget=64))
    audit_step(lambda: note_collective("all-gather", 64), AuditSpec())
    with pytest.raises(AuditError, match="hlo-peak-buffer"):
        audit_step(lambda: torch.zeros(1024), AuditSpec(peak_bytes=1))


def test_scorecard_budget_equals_jax():
    assert scorecard_budget_bytes(2, 4, 4) == 272
    for b in (1, 2, 16):
        for s in (1, 2, 4, 8):
            for k in (1, 4, 10):
                assert scorecard_budget_bytes(b, s, k) == \
                    j_scorecard_budget_bytes(b, s, k)


# ---------------------------------------------------------------------------
# warmed engines: clean ones pass, each rule fires with the bucket's label
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(flavor="dense"), dict(flavor="bandit"),
    dict(flavor="bandit", corpus_format="int8"),
    dict(flavor="bandit", corpus_format="residual"),
    dict(flavor="bandit", continuous=True),
    dict(flavor="bandit", bandit_engine="pooled_chain"),
    dict(flavor="bandit", bandit_engine="vmapped")],
    ids=["dense", "bandit", "int8", "residual", "continuous", "chain",
         "vmapped"])
def test_warmed_engines_pass_with_no_collectives(kw):
    eng = _engine(audit=True, **kw)
    eng.warmup()                                  # audit=True runs here
    rep = eng.audit()
    assert set(rep) == set(eng.compiled_buckets)
    assert all(r.collective_total == 0 for r in rep.values())
    loop = ("core/batched.py::run_batched_bandit"
            if kw.get("bandit_engine") == "vmapped" else LOOP)
    for key, r in rep.items():
        assert set(r.host_reads) <= {loop}, (key, r.host_reads)
        if key[0] in ("step", "stream") and kw["flavor"] == "bandit":
            assert r.host_reads[loop] > 0


@pytest.mark.parametrize("engine", ["pooled", "pooled_chain"])
def test_bandit_reads_are_the_loop_tests(engine, monkeypatch):
    """A bandit step's host reads are all run_loop's continue test: one per
    trip plus the last test when the loop ends by quiescence; the step's
    trips come from run_pooled_bandit's own result."""
    eng = _engine(flavor="bandit", bandit_engine=engine)
    eng.warmup()
    trips = []
    real = service.run_pooled_bandit

    def spy(*a, **k):
        res = real(*a, **k)
        # read after the audit: a read here would be one of the step's
        trips.append(res if hasattr(res, "trips") else res[0])
        return res
    monkeypatch.setattr(service, "run_pooled_bandit", spy)
    rep = eng.audit()[("step", "bandit", 8, 16)]
    trips = [int(r.trips) for r in trips]
    assert len(trips) == 1 and trips[0] > 1
    assert rep.host_reads == {LOOP: trips[0] + 1}
    assert rep.trips == trips[0]


def test_stream_reads_stop_at_the_trip_limit():
    """The continuous step stops at its trip limit, not by quiescence:
    exactly trip_limit loop tests."""
    eng = _engine(flavor="bandit", continuous=True, stream_trip_limit=3)
    eng.warmup()
    rep = eng.audit()[("stream", 8, 16)]
    assert rep.trips == 3 and rep.host_reads == {LOOP: 3}


def test_a_read_planted_in_fused_trip_fails(monkeypatch):
    """One extra scalar read inside the trip (through _guarded_stats, which
    fused_trip calls) fails hlo-host-sync even though run_loop's count is
    uncapped: a trip must hold no host read."""
    eng = _engine(flavor="bandit")
    eng.warmup()
    real = frontier._guarded_stats

    def leaky(vals, new, dstats):
        float(vals.sum())
        return real(vals, new, dstats)
    monkeypatch.setattr(frontier, "_guarded_stats", leaky)
    with pytest.raises(AuditError) as ei:
        eng.audit()
    assert ei.value.rule == "hlo-host-sync"
    assert "fused_trip" in str(ei.value)
    assert "('step', 'bandit', 8, 16)" in str(ei.value)


def _inject(eng, key, wrap):
    real = eng._exec[key]
    eng._exec[key] = lambda *args: wrap(real, *args)


def test_engine_audit_flags_an_item_in_a_step():
    eng = _engine(flavor="dense", audit=True)
    eng.warmup()
    key = ("step", "dense", 8, 16)

    def chatty(real, *args):
        out = real(*args)
        out[0].max().item()
        return out
    _inject(eng, key, chatty)
    with pytest.raises(AuditError) as ei:
        eng.audit()
    assert ei.value.rule == "hlo-host-sync"
    assert repr(key) in str(ei.value)
    assert "scalar read" in ei.value.lines[0]


def test_engine_audit_flags_f64():
    eng = _engine(flavor="dense")
    eng.warmup()
    key = ("step", "dense", 8, 16)
    _inject(eng, key, lambda real, *a: real(*a)[:1] + (a[2].double(),))
    with pytest.raises(AuditError) as ei:
        eng.audit()
    assert ei.value.rule == "hlo-f64" and repr(key) in str(ei.value)


def test_engine_audit_flags_a_bf16_corpus_upcast_whole(monkeypatch):
    """A bf16 corpus passes; the same step handed the corpus upcast whole
    to f32 at its boundary fails the promotion rule."""
    eng = _engine(torch.bfloat16, flavor="dense", audit=True)
    eng.warmup()
    key = ("step", "dense", 8, 16)
    real = eng._warm_args

    def promoted(k, round_cap):
        args = real(k, round_cap)
        return (args[0].float(),) + args[1:] if k == key else args
    monkeypatch.setattr(eng, "_warm_args", promoted)
    with pytest.raises(AuditError) as ei:
        eng.audit()
    assert ei.value.rule == "hlo-corpus-promotion"
    assert repr(key) in str(ei.value)


def test_engine_audit_require_bf16_flags_f32_corpus():
    eng = _engine(flavor="dense", audit=True, audit_require_bf16=True)
    with pytest.raises(AuditError) as ei:
        eng.warmup()
    assert ei.value.rule == "hlo-corpus-promotion"
    assert "('stage1', 8)" in str(ei.value)


def test_engine_audit_flags_an_int8_corpus_dequantized_whole():
    eng = _engine(flavor="dense", corpus_format="int8", audit=True)
    eng.warmup()
    key = ("step", "dense", 8, 16)

    def inflate(real, ce, *rest):
        dequantize(ce)
        return real(ce, *rest)
    _inject(eng, key, inflate)
    with pytest.raises(AuditError) as ei:
        eng.audit()
    assert ei.value.rule == "hlo-int8-residency"
    assert repr(key) in str(ei.value)


def test_engine_audit_peak_buffer_bound():
    eng = _engine(flavor="dense", audit=True, audit_peak_bytes=1)
    with pytest.raises(AuditError) as ei:
        eng.warmup()
    assert ei.value.rule == "hlo-peak-buffer"


def test_engine_audit_flags_collectives_off_mesh():
    """Off the mesh the budget is 0: a step that reports cross-shard bytes
    fails."""
    eng = _engine(flavor="dense")
    eng.warmup()
    key = ("step", "dense", 8, 16)

    def chatty(real, *args):
        note_collective("all-gather", 8)
        return real(*args)
    _inject(eng, key, chatty)
    with pytest.raises(AuditError) as ei:
        eng.audit()
    assert ei.value.rule == "hlo-collective-budget"


@pytest.mark.parametrize("flavor", ["dense", "bandit"])
def test_routed_mesh_warmup_audit_within_scorecard_budget(flavor):
    """The JAX pin: a 4-shard routed engine on a bf16 corpus warms under
    audit=True (with audit_require_bf16) and every sharded and routed
    step's logical cross-shard bytes lie in (0, scorecard_budget_bytes(2,
    4, 4)] = (0, 272]."""
    eng = _engine(torch.bfloat16, flavor=flavor, mesh_axes=(("data", 4),),
                  stage1="local", stage1_centroids=4, stage1_total=16,
                  audit=True, audit_require_bf16=True)
    eng.warmup()
    budget = scorecard_budget_bytes(2, 4, 4)
    reports = eng.audit()
    stepish = {k: r for k, r in reports.items() if k[0] in ("step",
                                                            "routed")}
    assert stepish and budget == 272
    for key, rep in stepish.items():
        assert 0 < rep.collective_total <= budget, (key, rep)
        assert set(rep.host_reads) <= {LOOP}


def test_mesh_bandit_reads_one_loop_per_shard():
    eng = _engine(flavor="bandit", mesh_axes=(("data", 2), ("model", 2)))
    eng.warmup()
    rep = eng.audit()[("step", "bandit", 8, 16)]
    # each shard's loop ends by quiescence: one extra test per shard
    assert rep.host_reads == {LOOP: rep.trips + 4}


# ---------------------------------------------------------------------------
# the index helpers, against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad_to", [None, 5, 12])
def test_index_helpers_equal_jax(pad_to):
    rng = np.random.default_rng(7)
    docs = [rng.standard_normal((n, 6)).astype(np.float32)
            for n in (3, 7, 1, 9)]
    idx = build_index_from_ragged(docs, pad_to, device="cpu")
    jidx = j_from_ragged(docs, pad_to)
    for f in ("doc_embs", "doc_mask", "doc_lens"):
        assert np.array_equal(getattr(idx, f).numpy(),
                              np.asarray(getattr(jidx, f)))
    assert (idx.n_docs, idx.max_len, idx.dim) == (jidx.n_docs, jidx.max_len,
                                                  jidx.dim)
    toks, owner = idx.flat_tokens()
    jtoks, jowner = jidx.flat_tokens()
    assert np.array_equal(toks.numpy(), np.asarray(jtoks))
    assert np.array_equal(owner.numpy(), np.asarray(jowner))
    assert owner.dtype == torch.int32
    ids = np.asarray([[2, -1, 0], [3, 3, 1]], np.int32)
    e, m = idx.gather_docs(torch.as_tensor(ids, dtype=torch.int64))
    je, jm = jidx.gather_docs(ids)
    assert np.array_equal(e.numpy(), np.asarray(je))
    assert np.array_equal(m.numpy(), np.asarray(jm))


# ---------------------------------------------------------------------------
# the examples, on the CPU at their default sizes
# ---------------------------------------------------------------------------

def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_quickstart_example(capsys):
    dense, bandit = _example("torch_quickstart").main(["--device", "cpu"])
    assert dense.topk_ids.shape == bandit.topk_ids.shape == (4, 5)
    assert (bandit.reveal_fraction < 1).all()
    assert "mean overlap@5" in capsys.readouterr().out


def test_torch_serve_retrieval_example(capsys):
    overlap = _example("torch_serve_retrieval").main(["--device", "cpu"])
    assert 0.0 <= overlap <= 1.0
    assert "served 16 queries" in capsys.readouterr().out


def test_torch_serve_stream_example(tmp_path, capsys):
    table = str(tmp_path / "t.json")
    engine, done = _example("torch_serve_stream").main(
        ["--device", "cpu", "--autotune", "--audit", "--tuning-table",
         table])
    assert len(done) == 64
    assert engine.metrics.compiles_after_warmup == 0
    assert engine.metrics.autotune_buckets == len(engine._autotune_dims())
    out = capsys.readouterr().out
    assert "audit ('step', 'bandit', 32, 64)" in out
    assert "compiles after warmup: 0" in out
