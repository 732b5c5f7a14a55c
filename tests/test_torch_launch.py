"""The port's launcher (``repro_torch.launch``), its account
(``repro_torch.analysis.accounting``) and ``dist/act_sharding.py``'s fit
against the JAX package, on the CPU.

* ``model_flops`` of every one of the 44 cells equals JAX's formulas on
  JAX's configs (``repro.launch.steps`` is imported, its ``build_cell``
  never called: it needs a real 256-device mesh).
* Per-device argument bytes of the 20 LM cells on both production meshes
  equal a composed JAX oracle: ``jax.eval_shape`` trees placed by JAX's
  ``specs_from_rules`` / batch / cache specs, each shard's shape taken from
  its spec.
* Argument and output bytes of four cells equal XLA's ``memory_stats``
  from JAX's own ``run_cell``, run in ONE subprocess (JAX's dryrun sets
  512 placeholder devices at import; it is never imported here). XLA's
  output figure adds an 8-byte tuple-table entry per output leaf when the
  output is a tuple, and the port's rerank returns int64 ids where JAX's
  are int32: both differences are stated and checked exactly.
* The fitted specs equal JAX's ``_apply`` (captured at its
  ``with_sharding_constraint``); the retrieval cells' reckoned kernel work
  counts the slots a shard fills and its pad slots apart; the reckoned
  collectives of a 2-layer LM on a (2, 2) mesh equal hand-worked values;
  the counted FLOPs scale with depth; the CLI runs a cell.
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as J_ARCHS
from repro.configs import get_config as jget_config
from repro.dist import act_sharding as JAS
from repro.dist import sharding as JSH
from repro.launch import steps as JSTEPS
from repro.models.transformer import init_cache as jinit_cache
from repro.models.transformer import init_lm as jinit_lm
from repro_torch.analysis import accounting as A
from repro_torch.configs import ASSIGNED_ARCHS, all_cells, get_config
from repro_torch.configs.base import LMConfig, ShapeSpec
from repro_torch.dist import act_sharding as AS
from repro_torch.dist.mesh import make_mesh
from repro_torch.launch import dryrun
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import gnn as G
from test_torch_threads import cap_torch_threads

cap_torch_threads()

pytestmark = pytest.mark.timeout(300)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAPER = ["colbert-text", "colbert-mm"]
CELLS = [(a, s.name) for a, _, s in all_cells(ASSIGNED_ARCHS + PAPER)]
LM_CELLS = [(a, s) for a, s in CELLS if get_config(a).family == "lm"]
MESHES = {"single-pod": {"data": 16, "model": 16},
          "multi-pod": {"pod": 2, "data": 16, "model": 16}}


class DescribedMesh:
    """A mesh of any size without devices: what JAX's helpers read."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.fixture(autouse=True)
def _clean_context():
    yield
    JAS.clear()


def _build(arch, shape, multi_pod=False, **kw):
    return STEPS.build_cell(arch, shape, make_production_mesh(
        multi_pod=multi_pod), **kw)


def test_registry_matches_jax():
    assert ASSIGNED_ARCHS == J_ARCHS
    assert len(CELLS) == 44 and len(LM_CELLS) == 20


# ---------------------------------------------------------------------------
# exact: model FLOPs and argument bytes
# ---------------------------------------------------------------------------

def _jax_model_flops(arch, shape_name):
    """JAX's model FLOPs of a cell, from its own formulas and configs
    (the node / edge arithmetic of its ``_gnn_cell``, the inline formula
    of its dense ``_retrieval_cell``)."""
    cfg = jget_config(arch)
    shape = next(s for s in cfg.shapes if s.name == shape_name)
    if cfg.family == "lm":
        return JSTEPS.lm_model_flops(cfg, shape)
    if cfg.family == "recsys":
        return JSTEPS.recsys_model_flops(cfg, shape)
    if cfg.family == "gnn":
        if shape.name == "minibatch_lg":
            f1, f2 = shape.fanout
            n = shape.batch_nodes * (1 + f1 + f1 * f2)
            e = shape.batch_nodes * (f1 + f1 * f2)
        elif shape.name == "molecule":
            n = shape.graph_batch * shape.n_nodes
            e = shape.graph_batch * shape.n_edges
        else:
            n, e = shape.n_nodes, shape.n_edges
        return JSTEPS.gnn_model_flops(cfg, n, e, shape.d_feat)
    return (shape.batch * shape.n_candidates * cfg.query_tokens
            * cfg.doc_tokens * cfg.dim * 2)


def test_model_flops_equal_jax_for_every_cell():
    for arch, shape in CELLS:
        cell = _build(arch, shape)
        assert cell.model_flops == _jax_model_flops(arch, shape), (arch,
                                                                  shape)


def _jshard_bytes(shape, dtype, spec, mesh_shape):
    n = 1
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    for dim, part in zip(shape, spec):
        axes = () if part is None else (
            part if isinstance(part, tuple) else (part,))
        k = math.prod(mesh_shape[a] for a in axes)
        assert dim % k == 0
        n *= dim // k
    return n * jnp.dtype(dtype).itemsize


def _jtree_bytes(tree, specs, mesh_shape):
    leaves = jax.tree.leaves(tree)
    sp = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(sp)
    return sum(_jshard_bytes(x.shape, x.dtype, s, mesh_shape)
               for x, s in zip(leaves, sp))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = jget_config(arch)
    return jax.eval_shape(lambda: jinit_lm(jax.random.key(0), cfg,
                                           dtype=jnp.bfloat16))


def _jax_lm_argument_bytes(arch, shape_name, mesh_shape):
    """The composed oracle: JAX's abstract trees, JAX's specs."""
    P = jax.sharding.PartitionSpec
    mesh = DescribedMesh(mesh_shape)
    cfg = jget_config(arch)
    shape = next(s for s in cfg.shapes if s.name == shape_name)
    params = _jax_params(arch)
    p_specs = JSH.specs_from_rules(params, JSH.lm_param_rules(mesh))
    total = _jtree_bytes(params, p_specs, mesh_shape)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        opt = JSH.specs_from_rules(params, JSH.lm_opt_rules(mesh))
        m = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, jnp.float32),
                         params)
        total += 2 * _jtree_bytes(m, opt, mesh_shape) + 4       # m, v, step
        total += 2 * _jshard_bytes((B, S), jnp.int32,
                                   JSH.lm_batch_spec(mesh), mesh_shape)
        return total
    if shape.kind == "prefill":
        return total + _jshard_bytes((B, S), jnp.int32,
                                     JSH.lm_batch_spec(mesh), mesh_shape)
    cache = jax.eval_shape(lambda: jinit_cache(cfg, B, S, jnp.bfloat16))
    cs = JSH.lm_cache_specs(mesh, B)
    c_specs = {k: type(v)(**cs) for k, v in cache.items()}
    tok = P(JSH.fsdp_axes(mesh)) if B > 1 else P()
    return (total + _jshard_bytes((B,), jnp.int32, tok, mesh_shape) + 4
            + _jtree_bytes(cache, c_specs, mesh_shape))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape", LM_CELLS,
                         ids=[f"{a}-{s}" for a, s in LM_CELLS])
def test_lm_argument_bytes_equal_the_composed_jax_oracle(arch, shape,
                                                         mesh_name):
    mesh_shape = MESHES[mesh_name]
    cell = _build(arch, shape, multi_pod=mesh_name == "multi-pod")
    got = A.placed_bytes(cell.args, cell.in_specs, mesh_shape)
    assert got == _jax_lm_argument_bytes(arch, shape, mesh_shape)


SUBPROCESS_CELLS = [("fm", "serve_p99"), ("sasrec", "train_batch"),
                    ("pna", "molecule"), ("colbert-text", "rerank_online")]

_JAX_RUN = """
import json
import jax
from repro.launch.dryrun import run_cell
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import build_cell
mesh = make_production_mesh()
out = {}
for arch, shape in %r:
    rec = run_cell(arch, shape, mesh, verbose=False)
    cell = build_cell(arch, shape, mesh)
    out[arch + "/" + shape] = dict(rec["memory"], out_leaves=len(
        jax.tree.leaves(cell.out_shardings)))
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_memory_stats():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c",
                          _JAX_RUN % (SUBPROCESS_CELLS,)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=240)
    line = [x for x in res.stdout.splitlines() if x.startswith("RESULT ")]
    assert res.returncode == 0 and line, res.stderr[-3000:]
    return json.loads(line[-1][len("RESULT "):])


@pytest.mark.parametrize("arch,shape", SUBPROCESS_CELLS,
                         ids=[f"{a}-{s}" for a, s in SUBPROCESS_CELLS])
def test_bytes_equal_xla_memory_stats(jax_memory_stats, arch, shape):
    want = jax_memory_stats[f"{arch}/{shape}"]
    rec = dryrun.run_cell(arch, shape, make_production_mesh(), verbose=False)
    exact = rec["exact"]
    assert exact["argument_bytes_per_device"] == want[
        "argument_size_in_bytes"]
    n_out = want["out_leaves"]
    table = 8 * n_out if n_out > 1 else 0       # XLA's tuple index table
    out = exact["output_bytes_per_device"]
    if arch == "colbert-text":                   # int64 ids, JAX's int32
        cfg = get_config(arch)
        shape_spec = next(s for s in cfg.shapes if s.name == shape)
        out -= shape_spec.batch * STEPS.TOPK * 4
    assert out + table == want["output_size_in_bytes"]


# ---------------------------------------------------------------------------
# act_sharding's fit
# ---------------------------------------------------------------------------

def _jax_fitted(monkeypatch, x, parts=None, name=None):
    """The spec JAX's ``_apply`` constrains ``x`` to (None: unchanged)."""
    monkeypatch.setattr(JAS, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: tuple(spec))
    out = (JAS.constrain(x, *parts) if name is None
           else JAS.constrain_named(x, name))
    return out if isinstance(out, tuple) else None


@pytest.mark.parametrize("mesh_shape", list(MESHES.values()) + [
    {"data": 2, "model": 2}, {"x": 4}], ids=["16x16", "2x16x16", "2x2", "x4"])
def test_fitted_specs_equal_jax(monkeypatch, mesh_shape):
    mesh = DescribedMesh(mesh_shape)
    shapes = [(256, 4096), (128, 4096, 2048), (1, 36), (32, 6), (48, 30)]
    parts_list = [("dp", None), ("dp", "tp"), (None, "tp"), ("tp", "dp"),
                  (("data", "model"), None), ("pod", "tp"),
                  ("dp", None, "tp"), ("x", None), ("nope", "tp")]
    for axes in (None, "dp_all"):
        JAS.set_mesh(mesh)
        if axes:
            JAS.set_axes(tuple(mesh.axis_names), None)
        for shape in shapes:
            x = jax.ShapeDtypeStruct(shape, jnp.float32)
            for parts in parts_list:
                if len(parts) != len(shape):
                    continue
                assert AS.fitted_spec(shape, parts, mesh,
                                      dp_all=bool(axes)) == _jax_fitted(
                    monkeypatch, x, parts), (shape, parts, axes)
    # the decode cell's cache slices (JAX's named extra "cache_kv")
    if "model" in mesh_shape:
        for batch in (128, 1):
            JAS.set_mesh(mesh)
            spec = tuple(JSH.lm_cache_specs(mesh, batch)["k"])[1:]
            JAS.set_extra("cache_kv", jax.sharding.PartitionSpec(*spec))
            shape = (batch, 32768, 2, 128)
            x = jax.ShapeDtypeStruct(shape, jnp.bfloat16)
            assert AS.fitted_spec(shape, spec, mesh) == _jax_fitted(
                monkeypatch, x, name="cache_kv")
    assert AS.fitted_spec((4, 4, 4), ("dp", "tp"), mesh) is None


# ---------------------------------------------------------------------------
# reckoned collectives and the count
# ---------------------------------------------------------------------------

TINY = LMConfig(name="tiny", n_layers=2, d_model=8, n_heads=2, n_kv_heads=2,
                d_head=4, d_ff=16, vocab=32)


def _tiny_cell(kind, **shape):
    mesh = make_mesh((2, 2), ("data", "model"), device="meta")
    return STEPS._lm_cell(TINY, ShapeSpec(name=kind, kind=kind, **shape),
                          mesh)


def test_reckoned_collectives_of_a_two_layer_lm_by_hand():
    # zero3 on {data 2, model 2}, bf16; per-device shard / gathered bytes:
    # embed (32, 8) and head (8, 32): 128 / 256 each; final_norm (8,): 8 /
    # 16; a layer: ln1, ln2 8 / 16 each, wq wk wv wo (8, 8) 32 / 64 each,
    # w_gate w_up (8, 16) and w_down (16, 8) 64 / 128 each: 336 / 672.
    gathered = 256 + 256 + 16 + 2 * 672              # 1,872 a pass
    shards = 128 + 128 + 8 + 2 * 336                 # 936 (all FSDP-split)
    norms = 8 + 2 * (8 + 8)                          # 40: replicated on model
    act = 2 * 8 * 8 * 2                              # B/dp=2 x S=8 x D=8 bf16
    pre = A.collective_bytes(_tiny_cell("prefill", seq_len=8,
                                        global_batch=4).collectives)
    assert pre == {"all-gather": gathered, "all-reduce": 2 * 2 * act,
                   "total": gathered + 4 * act}
    # train: B // dp = 2 microbatches; per microbatch 2 passes of gathers,
    # a reduce-scatter of every shard, the norms' all-reduce, and 4 TP
    # all-reduces a layer (forward + backward) of the microbatch's rows
    tr = A.collective_bytes(_tiny_cell("train", seq_len=8,
                                       global_batch=4).collectives)
    assert tr == {"all-gather": 2 * 2 * gathered,
                  "reduce-scatter": 2 * shards,
                  "all-reduce": 2 * norms + 4 * 2 * act,
                  "total": 4 * gathered + 2 * shards + 2 * norms + 8 * act}
    # decode, B = 4 over data, the 16-slot cache's sequence over model: the
    # split-K combine, (B/2) x H=2 x (Dh + 2) float32 a layer, and two TP
    # all-reduces a layer of (2, 1, 8) bf16
    de = A.collective_bytes(_tiny_cell("decode", seq_len=16,
                                       global_batch=4).collectives)
    combine = 2 * 2 * (4 + 2) * 4
    assert de == {"all-gather": gathered,
                  "all-reduce": 2 * combine + 2 * 2 * (2 * 8 * 2),
                  "total": gathered + 2 * combine + 4 * 32}
    # links: a 2 x 2 mesh is one host; a 16-way axis spans two
    assert A.link_of(("model",), {"data": 2, "model": 2}) == "nvlink"
    assert A.link_of(("model",), MESHES["single-pod"]) == "nic"
    assert A.link_of(("data",), {"data": 2, "model": 4}) == "nvlink"
    assert A.link_of(("data",), {"data": 4, "model": 4}) == "nic"


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_retrieval_work_is_reckoned_over_the_filled_slots(multi_pod):
    """The retrieval cells' kernel work is a formula, filed under
    ``reckoned``: FLOPs over the N / devices slots a shard fills on
    average, the pad slots of the 4x routing headroom counted apart."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = get_config("colbert-text")
    L, M, T = cfg.doc_tokens, cfg.dim, cfg.query_tokens
    for shape in ("rerank_online", "rerank_bulk"):
        rec = dryrun.run_cell("colbert-text", shape, mesh, verbose=False)
        assert rec["counted"] is None
        w = rec["reckoned"]["kernel_work"]
        spec = next(s for s in cfg.shapes if s.name == shape)
        B, N, n_dev = spec.batch, spec.n_candidates, mesh.size
        n_loc = -(-N * 4 // n_dev)
        assert w["filled_slots"] == B * N / n_dev
        assert w["pad_slots"] == B * n_loc - B * N / n_dev > 0
        assert w["flops_by_dtype"] == {
            "float32": 2 * B * N / n_dev * T * L * M}
        assert rec["reckoned"]["useful_flops_frac"] == pytest.approx(1.0)
        assert rec["reckoned"]["memory_s"] == pytest.approx(
            w["unfused_bytes_per_device"] / dryrun.HBM_BW)


def test_counted_flops_are_linear_in_depth():
    mesh = make_production_mesh()
    counts = []
    for depth in (1, 2, 3):
        cell = STEPS.build_cell("qwen2.5-3b", "decode_32k", mesh,
                                depth=depth)
        counts.append(A.count_step(cell.count)[1])
    f = [c.flops for c in counts]
    assert f[2] - f[1] == f[1] - f[0] > 0
    assert all(c.flops_by_dtype.get("bfloat16", 0) > 0 for c in counts)


def test_pna_shard_program_is_the_sharded_loss_at_one_shard():
    cfg = dataclasses.replace(get_config("pna"), n_layers=2, d_hidden=8,
                              n_classes=5)
    g = G.random_graph(24, 60, 6, 5, seed=0)
    params = G.init_pna(cfg, 6, seed=0, device="cpu")
    mesh1 = make_mesh((1,), ("x",), device="cpu")
    batch = G.GraphBatch(g.feats, g.senders, g.receivers,
                         torch.ones(60, dtype=torch.bool), g.node_mask,
                         g.labels)
    want = G.pna_loss_sharded(params, cfg, batch, mesh1)
    got = STEPS.pna_shard_loss(params, cfg, batch, 1)
    assert torch.equal(got, want)
    # the cell's count at one device == the cell's step on a 1-shard mesh
    cell = STEPS.build_cell("pna", "molecule",
                            make_mesh((1,), ("x",), device="meta"))
    _, c_shard = A.count_step(cell.count)
    _, c_step = A.count_step(lambda: cell.fn(*cell.args))
    assert c_shard.flops == c_step.flops > 0


def test_noted_collectives_are_kept_by_kind():
    from repro_torch.analysis.audit import note_collective

    def fn():
        note_collective("all-gather", 100)
        note_collective("all-gather", 20)
        return torch.zeros(4, device="meta") @ torch.zeros(4, 3,
                                                            device="meta")

    out, c = A.count_step(fn)
    assert c.noted_collective_bytes == {"all-gather": 120}
    assert c.flops == 2 * 4 * 3 and c.flops_by_dtype == {"float32": 24}
    assert tuple(out.shape) == (3,)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_accounts_one_cell(tmp_path, capsys):
    out = tmp_path / "dryrun.json"
    rc = dryrun.main(["--arch", "fm", "--shape", "serve_p99", "--out",
                      str(out)])
    assert rc == 0
    data = json.loads(out.read_text())
    assert data["failures"] == [] and len(data["records"]) == 1
    rec = data["records"][0]
    assert rec["exact"]["argument_bytes_per_device"] == 106_055_556
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert "no HLO" in rec["method"]
    assert data["constants"]["peak_flops"]["bfloat16"] == 989e12
    assert data["constants"]["hbm_bw"] == 3.35e12
    assert set(data["constants"]["link_bw"]) == {"nvlink", "nic"}
    assert rc == dryrun.main(["--arch", "fm", "--shape", "serve_p99",
                              "--multi-pod"])
    assert dryrun.main(["--arch", "fm", "--shape", "no_such_shape"]) == 1
    assert "1 failures" in capsys.readouterr().out


# Qwen2.5-3B's decode records on the single-pod mesh as accounted before
# the cache could be placed in per-device blocks: per-device argument and
# output bytes, counted FLOPs and unfused bytes, reckoned collective bytes
# (and, with split-K bound, the combine's noted all-reduce bytes). The
# launcher counts an unplaced cache on ``meta``, so none of them moves.
DECODE_RECORDS = {
    ("decode_32k", False): (630_613_540, 604_197_248, 2_026_889_019_392,
                            2_409_992_192_632, 424_906_752, 4_755_456, {}),
    ("long_500k", False): (1_234_658_824, 1_208_109_616, 160_790_216_704,
                           152_192_807_652, 424_906_752, 594_432, {}),
    ("long_500k", True): (1_234_658_824, 1_208_109_616, 160_790_216_704,
                          159_489_118_020, 424_906_752, 594_432,
                          {"all-reduce": 4_792_320}),
}


@pytest.mark.parametrize("shape,flash_decode", list(DECODE_RECORDS))
def test_qwen_decode_records_are_unchanged(shape, flash_decode):
    rec = dryrun.run_cell("qwen2.5-3b", shape, make_production_mesh(),
                          verbose=False, flash_decode=flash_decode)
    args, outs, flops, unfused, gathered, reduced, noted = \
        DECODE_RECORDS[shape, flash_decode]
    assert rec["exact"]["argument_bytes_per_device"] == args
    assert rec["exact"]["output_bytes_per_device"] == outs
    assert rec["counted"]["counted_flops"] == flops
    assert rec["counted"]["counted_unfused_bytes"] == unfused
    assert rec["counted"]["noted_collective_bytes"] == noted
    assert rec["reckoned"]["collective_bytes_per_device"] == {
        "all-gather": gathered, "all-reduce": reduced,
        "total": gathered + reduced}
