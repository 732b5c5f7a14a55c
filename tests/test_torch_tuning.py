"""The port's launch-shape tuning (``repro_torch.kernels.tuning``, the
tuning half of ``kernels/ops.py`` and the engine's autotune / tuning-table
path) on the CPU, against the JAX package's ``repro.kernels.tuning`` and
engine.

The knobs differ by design (the port tunes ``block_n`` docs per block of
the dense kernel and ``block_l`` tokens per staged chunk of the reveal
kernel; JAX's Pallas kernels tune block_n / block_t / block_l / block_b),
so parity is on what both share: the bucket keys, the table rows' shape,
the dims each op derives from its launch, and the engine's list of
(op, dims) buckets, list for list. On the CPU the ops run their plain
versions and ignore launch shapes, as JAX's ``ref`` lane does, so an
engine's completions cannot depend on the table; the card tests
(``test_torch_cuda.py``) hold every candidate's outputs to the default's
bit for bit. In-process, no subprocess.
"""
import json

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import tuning as jtuning
from repro.kernels.quant import corpus_asarray
from repro.kernels.quant import quantize_int8 as jquantize_int8
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import RetrievalEngine as JRetrievalEngine
from repro.data.synthetic import make_retrieval_dataset
from repro_torch.dist import mesh as tmesh
from repro_torch.kernels import ops, tuning
from repro_torch.kernels.quant import quantize_int8
from repro_torch.serve import EngineConfig, Request, RetrievalEngine
from repro_torch.serve import engine as engine_mod
from test_torch_threads import cap_torch_threads

cap_torch_threads()

DIMS = [dict(N=5, T=32, L=128, M=128),
        dict(B=16, N=64, T=32, L=128, M=128),
        dict(B=128, G=8, L=128, M=128, D=4096, TQ=512),
        dict(B=128, G=8, L=128, M=128, D=4096, TQ=512, FMT=2),
        dict(B=3, G=1, L=77, M=100, D=33, TQ=45, FMT=4)]


@pytest.fixture(autouse=True)
def clean_tables():
    """Both packages' tables are process-wide caches: start and end empty,
    so no other test in this worker sees an entry."""
    tuning.clear()
    jtuning.clear()
    yield
    tuning.clear()
    jtuning.clear()


@pytest.fixture(scope="module")
def corpus():
    return make_retrieval_dataset(n_docs=48, n_queries=12, doc_len=16,
                                  min_doc_len=6, query_len=16, dim=16,
                                  seed=5)


# ---------------------------------------------------------------------------
# the table: parity with repro.kernels.tuning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x", [0, 1, 2, 3, 5, 8, 9, 100, 128, 129, 4096,
                               65536, 65537])
def test_pow2_bucket_equals_jax(x):
    assert tuning._pow2_bucket(x) == jtuning._pow2_bucket(x)


@pytest.mark.parametrize("dims", DIMS)
def test_bucket_keys_and_rows_equal_jax(dims):
    op = "maxsim_batch" if "N" in dims else "fused_reveal"
    assert tuning.bucket_key(op, dims) == jtuning.bucket_key(op, dims)
    tuning.record(op, dims, dict(tuning.DEFAULTS[op]))
    jtuning.record(op, dims, dict(jtuning.DEFAULTS[op]))
    (row,), (jrow,) = tuning.table_json(), jtuning.table_json()
    assert row.keys() == jrow.keys() == {"op", "bucket", "config"}
    assert (row["op"], row["bucket"]) == (jrow["op"], jrow["bucket"])


def test_json_round_trip_and_only_the_given_keys(tmp_path):
    path = str(tmp_path / "table.json")
    mine = [("maxsim_batch", DIMS[1], {"block_n": 4}),
            ("fused_reveal", DIMS[2], {"block_l": 32}),
            ("gather_maxsim", DIMS[3], {"block_l": 64})]
    for op, dims, cfg in mine:
        tuning.record(op, dims, cfg)
    tuning.record("maxsim", DIMS[0], {"block_n": 1})       # not persisted
    keys = {tuning.bucket_key(op, dims) for op, dims, _ in mine}
    tuning.save_table(path, keys=keys)
    rows = json.load(open(path))
    assert len(rows) == 3
    tuning.clear()
    assert tuning.load_table(path) == 3
    for op, dims, cfg in mine:
        assert tuning.lookup(op, dims) == cfg
    assert tuning.lookup("maxsim", DIMS[0]) == tuning.DEFAULTS["maxsim"]


def test_loading_a_jax_table_raises_and_loads_nothing(tmp_path):
    """A JAX table carries block_t / block_b: the port has no such knob,
    so load_table raises ValueError and the live table stays as it was."""
    path = str(tmp_path / "jax.json")
    jtuning.record("maxsim_batch", DIMS[1], dict(jtuning.DEFAULTS[
        "maxsim_batch"]))
    jtuning.record("fused_reveal", DIMS[2], dict(jtuning.DEFAULTS[
        "fused_reveal"]))
    jtuning.save_table(path)
    tuning.record("maxsim", DIMS[0], {"block_n": 4})
    before = tuning.table()
    with pytest.raises(ValueError, match="no knob"):
        tuning.load_table(path)
    assert tuning.table() == before
    for bad in ({"block_n": 3}, {"block_l": 0}, {"block_t": 8}):
        with pytest.raises(ValueError):
            tuning.record("maxsim_batch", DIMS[1], bad)
    with pytest.raises(ValueError, match="unknown op"):
        tuning.record("masked_maxsim", DIMS[0], {"block_n": 2})


@pytest.mark.parametrize("N,want", [(1, [1]), (2, [1, 2]), (3, [1, 2, 4]),
                                    (64, [1, 2, 4])])
def test_candidates_are_clamped_and_deduped(N, want):
    """A block of more docs than N launches as the smallest built shape
    covering N, and candidates that collapse are timed once; the reveal
    ops' two shapes stay."""
    got = tuning.candidates("maxsim_batch", dict(B=2, N=N, T=8, L=8, M=8))
    assert [c["block_n"] for c in got] == want
    assert tuning.candidates("fused_reveal", DIMS[2]) == [
        {"block_l": 64}, {"block_l": 32}]
    jc = jtuning.candidates("maxsim_batch", dict(B=2, N=N, T=8, L=8, M=8))
    assert len(jc) == len({json.dumps(c, sort_keys=True) for c in jc})


def test_autotune_records_the_fastest_candidate(monkeypatch):
    cost = {1: 3.0, 2: 2.0, 4: 1.0}
    monkeypatch.setattr(tuning, "time_call",
                        lambda fn, repeats, device: fn())

    def runner(block_n):
        return lambda: cost[block_n]
    best, times = tuning.autotune("maxsim_batch", DIMS[1], runner)
    assert best == {"block_n": 4}
    assert tuning.lookup("maxsim_batch", DIMS[1]) == {"block_n": 4}
    assert sorted(times.values()) == [1.0, 2.0, 3.0]
    cost[1] = 0.5
    best, _ = tuning.autotune("maxsim_batch", DIMS[1], runner)
    assert best == {"block_n": 1}


@pytest.mark.parametrize("op,dims", [("maxsim", DIMS[0]),
                                     ("maxsim_batch", DIMS[1]),
                                     ("fused_reveal", DIMS[2]),
                                     ("gather_maxsim", DIMS[4])])
def test_cpu_autotune_op_records_nothing(op, dims):
    """On the CPU the ops ignore launch shapes: autotune_op returns the
    defaults unmeasured and records nothing (JAX's ref lane)."""
    assert ops.autotune_op(op, dims, device="cpu") == (
        tuning.DEFAULTS[op], {})
    assert tuning.table() == {}
    with pytest.raises(ValueError, match="unknown op"):
        ops.autotune_op("masked_maxsim", dims, device="cpu")


def test_resolve_explicit_beats_tuned_beats_default():
    dims = DIMS[1]
    assert ops._resolve("maxsim_batch", dims) == {"block_n": 2}
    tuning.record("maxsim_batch", dims, {"block_n": 4})
    assert ops._resolve("maxsim_batch", dims) == {"block_n": 4}
    assert ops._resolve("maxsim_batch", dims, block_n=1) == {"block_n": 1}
    assert ops._resolve("maxsim_batch", dims, block_n=None) == {"block_n": 4}
    assert ops._resolve("fused_reveal", DIMS[2]) == {"block_l": 0}
    assert ops._resolve("fused_reveal", DIMS[2], block_l=32) == {
        "block_l": 32}
    with pytest.raises(ValueError):
        ops._resolve("maxsim_batch", dims, block_n=3)


def test_plain_ops_take_and_validate_the_knobs():
    """The CPU ops accept every knob value and give the same result (the
    plain versions ignore them); a value no kernel shape has raises."""
    rng = np.random.default_rng(0)
    e = torch.as_tensor(rng.standard_normal((2, 5, 8, 16), np.float32))
    m = torch.ones((2, 5, 8), dtype=torch.bool)
    q = torch.as_tensor(rng.standard_normal((2, 4, 16), np.float32))
    base = ops.maxsim_batch_op(e, m, q)
    for bn in (1, 2, 4):
        assert torch.equal(ops.maxsim_batch_op(e, m, q, block_n=bn), base)
    assert torch.equal(ops.maxsim_op(e[0], m[0], q[0], block_n=4), base[0])
    with pytest.raises(ValueError, match="block_n"):
        ops.maxsim_batch_op(e, m, q, block_n=8)
    di = torch.tensor([0, 3, 9])
    ti = torch.tensor([[0, 1], [2, 3], [7, 1]])
    nm = torch.ones((3, 2), dtype=torch.bool)
    flat_e, flat_m = e.reshape(10, 8, 16), m.reshape(10, 8)
    flat_q = q.reshape(8, 16)
    v = ops.gather_maxsim_op(flat_e, flat_m, flat_q, di, ti)
    for bl in (0, 32, 64):
        assert torch.equal(ops.gather_maxsim_op(flat_e, flat_m, flat_q, di,
                                                ti, block_l=bl), v)
        assert torch.equal(ops.fused_reveal_op(flat_e, flat_m, flat_q, di,
                                               ti, nm, block_l=bl)[0], v)
    with pytest.raises(ValueError, match="block_l"):
        ops.fused_reveal_op(flat_e, flat_m, flat_q, di, ti, nm, block_l=16)


# ---------------------------------------------------------------------------
# dims: each op's launch -> the JAX keys; the engine's buckets == JAX's
# ---------------------------------------------------------------------------

def test_launch_dims_equal_jax_fmt_dims():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 8, 16)).astype(np.float32)
    jq = corpus_asarray(jquantize_int8(x))
    tq = quantize_int8(torch.as_tensor(x))
    assert ops.launch_dims("maxsim", tq.shape, (4, 16), "int8") == \
        jops._fmt_dims(dict(N=6, T=4, L=8, M=16), jq)
    assert ops.launch_dims("maxsim", (6, 8, 16), (4, 16)) == \
        jops._fmt_dims(dict(N=6, T=4, L=8, M=16), x)
    assert ops.launch_dims("maxsim_batch", (2, 3, 8, 16), (2, 4, 16)) == \
        dict(B=2, N=3, T=4, L=8, M=16)
    for op in ("fused_reveal", "gather_maxsim"):
        assert ops.launch_dims(op, (6, 8, 16), (12, 16), "residual",
                               (5, 3)) == dict(B=5, G=3, L=8, M=16, D=6,
                                               TQ=12, FMT=4)
    with pytest.raises(ValueError):
        ops.launch_dims("masked_maxsim", (6, 8, 16), (4, 16))


ENGINE_CFGS = {
    "dense": dict(flavor="dense"),
    "bandit": dict(flavor="bandit"),
    "auto": dict(flavor="auto", bandit_min_candidates=32),
    "growth": dict(flavor="bandit", max_block_docs=16, max_block_tokens=12),
    "docs_only": dict(flavor="auto", bandit_min_candidates=32,
                      max_block_docs=32),
    "int8": dict(flavor="auto", bandit_min_candidates=32,
                 corpus_format="int8"),
    "int8_growth": dict(flavor="bandit", corpus_format="int8",
                        max_block_tokens=16),
}


def _cfg_kw(name):
    return dict(batch_size=4, token_buckets=(8, 16), cand_buckets=(16, 32),
                max_k=5, stage1_candidates=16, stage1_kprime=4,
                **ENGINE_CFGS[name])


@pytest.mark.parametrize("name", sorted(ENGINE_CFGS))
def test_autotune_dims_equal_the_jax_engine(corpus, name):
    kw = _cfg_kw(name)
    eng = RetrievalEngine(corpus.doc_embs, corpus.doc_mask,
                          EngineConfig(**kw), device="cpu")
    jeng = JRetrievalEngine(corpus.doc_embs, corpus.doc_mask,
                            JEngineConfig(**kw))
    assert eng._autotune_dims() == jeng._autotune_dims()


@pytest.mark.parametrize("name", ["auto", "growth", "int8_growth"])
def test_served_launches_are_the_tuned_buckets(corpus, name, monkeypatch):
    """Every (op, dims) the ops derive while a warmed engine serves is one
    of ``_autotune_dims``, except the pooled bodies' init reveal (one token
    per candidate: Q*N rows, G = 1), which JAX does not tune either and
    which resolves to the default."""
    eng = RetrievalEngine(corpus.doc_embs, corpus.doc_mask,
                          EngineConfig(**_cfg_kw(name)), device="cpu")
    eng.warmup()
    seen = []
    real = ops._resolve

    def spy(op, dims, **kw):
        seen.append((op, dict(dims)))
        return real(op, dims, **kw)
    monkeypatch.setattr(ops, "_resolve", spy)
    rng = np.random.default_rng(2)
    for i in range(8):
        cand = (rng.choice(48, 32 if i % 2 else 12, replace=False)
                if name.startswith("int8") or i % 3 else None)
        eng.submit(Request(query=corpus.queries[i][:8 + i % 8], k=5,
                           cand_ids=cand))
    assert len(eng.drain()) == 8
    tuned = eng._autotune_dims()
    B = eng.cfg.batch_size
    init = [(op, d) for op, d in seen if (op, d) not in tuned]
    assert seen and len(init) < len(seen)
    for op, d in init:
        assert op in ("fused_reveal", "gather_maxsim") and d["G"] == 1
        assert d["B"] == d["D"] and d["D"] in {B * nb for nb in (16, 32)}
        assert real(op, d) == tuning.DEFAULTS[op]


# ---------------------------------------------------------------------------
# the engine's autotune / tuning_table path
# ---------------------------------------------------------------------------

def _fake_autotune(calls):
    """An autotune_op that records a non-default shape without timing."""
    pick = {"maxsim_batch": {"block_n": 4}, "maxsim": {"block_n": 1},
            "fused_reveal": {"block_l": 32}, "gather_maxsim": {"block_l": 64}}

    def fake(op, dims, **kw):
        calls.append((op, dict(dims), kw))
        tuning.record(op, dims, pick[op])
        return pick[op], {json.dumps(pick[op]): 1e-3}
    return fake


def test_engine_autotune_persists_loads_and_serves_the_same(
        corpus, tmp_path, monkeypatch):
    path = str(tmp_path / "tuning.json")
    foreign = ("maxsim", dict(N=999, T=3, L=7, M=5))
    calls = []
    monkeypatch.setattr(engine_mod, "autotune_op", _fake_autotune(calls))
    tuning.record(*foreign, {"block_n": 2})       # another engine's bucket
    kw = _cfg_kw("auto")
    eng = RetrievalEngine(corpus.doc_embs, corpus.doc_mask,
                          EngineConfig(autotune=True, tuning_table=path,
                                       **kw), device="cpu")
    eng.warmup()
    buckets = eng._autotune_dims()
    assert len(calls) == len(buckets) == eng.metrics.autotune_buckets
    assert all(c[2]["device"] == torch.device("cpu") for c in calls)
    rows = json.load(open(path))
    keys = {tuning.bucket_key(op, dims) for op, dims in buckets}
    assert len(rows) == len(keys)
    assert {(r["op"], tuple(sorted(r["bucket"].items()))) for r in rows} \
        == keys
    assert tuning.bucket_key(*foreign) not in {
        (r["op"], tuple(sorted(r["bucket"].items()))) for r in rows}
    assert eng.metrics.compiles_after_warmup == 0

    # A second engine loads the table and times nothing.
    tuning.clear()
    calls.clear()
    eng2 = RetrievalEngine(corpus.doc_embs, corpus.doc_mask,
                           EngineConfig(autotune=True, tuning_table=path,
                                        **kw), device="cpu")
    eng2.warmup()
    assert eng2.metrics.tuning_entries_loaded == len(rows)
    assert eng2.metrics.autotune_buckets == 0 and calls == []
    s = eng2.metrics.summary()
    assert s["tuning_entries_loaded"] == len(rows)
    assert s["autotune_buckets"] == 0

    # Completions of the tuned engine equal an untuned one's bit for bit.
    plain = RetrievalEngine(corpus.doc_embs, corpus.doc_mask,
                            EngineConfig(**kw), device="cpu")
    plain.warmup()
    rng = np.random.default_rng(3)
    reqs = [Request(query=corpus.queries[i][:8 + i % 9], k=5,
                    cand_ids=(rng.choice(48, 20 + i, replace=False)
                              if i % 3 else None)) for i in range(12)]
    outs = []
    for e in (eng2, plain):
        for r in reqs:
            e.submit(r)
        outs.append({c.rid: c for c in e.drain()})
        assert e.metrics.compiles_after_warmup == 0
    assert sorted(outs[0]) == sorted(outs[1])
    for rid, c in outs[0].items():
        w = outs[1][rid]
        assert np.array_equal(c.topk_ids, w.topk_ids)
        assert np.array_equal(c.topk_scores, w.topk_scores)
        assert c.reveal_fraction == w.reveal_fraction


def test_engine_without_autotune_only_loads(corpus, tmp_path, monkeypatch):
    path = str(tmp_path / "t.json")
    tuning.record("maxsim_batch", DIMS[1], {"block_n": 4})
    tuning.save_table(path)
    tuning.clear()
    calls = []
    monkeypatch.setattr(engine_mod, "autotune_op", _fake_autotune(calls))
    eng = RetrievalEngine(corpus.doc_embs, corpus.doc_mask,
                          EngineConfig(tuning_table=path, **_cfg_kw("dense")),
                          device="cpu")
    eng.warmup()
    assert eng.metrics.tuning_entries_loaded == 1 and calls == []
    assert tuning.lookup("maxsim_batch", DIMS[1]) == {"block_n": 4}


def test_cpu_engine_autotune_times_nothing(corpus):
    """The real autotune_op on a CPU engine: every bucket goes through it,
    nothing is recorded (the ops ignore launch shapes on the CPU)."""
    eng = RetrievalEngine(corpus.doc_embs, corpus.doc_mask,
                          EngineConfig(autotune=True, **_cfg_kw("auto")),
                          device="cpu")
    eng.warmup()
    assert eng.metrics.autotune_buckets == len(eng._autotune_dims())
    assert tuning.table() == {}


# ---------------------------------------------------------------------------
# the engine's mesh: one card per shard where the host has as many
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cards,want", [
    (4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    (8, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    (2, ["cuda:0"] * 4), (1, ["cuda:0"] * 4)])
def test_mesh_devices_one_card_per_shard(monkeypatch, cards, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert [str(d) for d in tmesh.mesh_devices(4, "cuda")] == want
    mesh = tmesh.make_host_mesh(4, device="cuda")
    assert [str(d) for d in mesh.devices] == want
    assert [str(d) for d in tmesh.mesh_devices(4, "cpu")] == ["cpu"] * 4


def test_engine_mesh_uses_mesh_devices(corpus, monkeypatch):
    """The engine builds its mesh through mesh_devices (jax.make_mesh's
    placement): on a CPU engine every shard is on the CPU."""
    seen = []
    real = engine_mod.mesh_devices

    def spy(n, device):
        seen.append((n, str(device)))
        return real(n, device)
    monkeypatch.setattr(engine_mod, "mesh_devices", spy)
    eng = RetrievalEngine(corpus.doc_embs, corpus.doc_mask,
                          EngineConfig(mesh_axes=(("data", 2), ("model", 2)),
                                       **_cfg_kw("dense")), device="cpu")
    assert seen == [(4, "cpu")]
    assert [str(d) for d in eng.sharded.mesh.devices] == ["cpu"] * 4


def test_new_entry_points_default_to_cuda():
    """autotune_op and build_index_from_ragged run on the card unless the
    caller asks for the CPU; without a card they raise, never fall back."""
    from repro_torch.retrieval.index import build_index_from_ragged
    docs = [np.ones((2, 4), np.float32), np.ones((3, 4), np.float32)]
    if torch.cuda.is_available():
        assert build_index_from_ragged(docs).doc_embs.is_cuda
        return
    with pytest.raises((RuntimeError, AssertionError)):
        build_index_from_ragged(docs)
    with pytest.raises((RuntimeError, AssertionError)):
        ops.autotune_op("maxsim_batch", dict(B=1, N=2, T=2, L=4, M=4))
    assert tuning.table() == {}
