"""The port's placement rules (``repro_torch.dist.sharding``) and ring
collectives (``repro_torch.dist.collectives``) against the JAX package's,
on the CPU, in one process.

Rules: every parameter of the port's LM (each LM arch of the registry at
full width and depth: dense, MoE, gemma2), PNA and the four recsys models
is built on the ``meta`` device and gets the spec JAX's
``specs_from_rules`` gives the matching leaf of JAX's abstract tree
(``jax.eval_shape``), on the trailing dims (JAX stacks layers, and the
stacking dims must be ``None``), at JAX's production mesh shapes {"data":
16, "model": 16} and {"pod": 2, "data": 16, "model": 16}, described by a
duck-typed mesh (``.shape``, ``.axis_names``) that JAX's helpers accept.
A port name maps to its JAX leaf through ``jax_leaf_groups`` (LM),
``layers.<i>.x`` -> ``layers.x`` (PNA) or as is (recsys). The divisibility
drops come with the full widths: PNA's d_hidden 75, the recsys rows padded
to 4,096.

Collectives: ``ring_all_gather`` and ``ring_matmul`` at S = 4 against
JAX's under ``jax.vmap(..., axis_name="x")`` (``ppermute`` batches there):
the gather bit for bit, the product within rtol 1e-6 (the per-row dot
products sum in each framework's order).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.dist import collectives as JC
from repro.dist import sharding as JSH
from repro.models import gnn as JG
from repro.models import recsys as JR
from repro.models.transformer import init_lm as jinit_lm
from repro_torch.analysis import audit
from repro_torch.configs import get_config
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as SH
from repro_torch.dist.mesh import make_mesh
from repro_torch.models import recsys as R
from repro_torch.models.gnn import PNA
from repro_torch.models.transformer import DecoderLM
from repro_torch.train.compressed_step import jax_leaf_groups
from test_torch_threads import cap_torch_threads

cap_torch_threads()

pytestmark = pytest.mark.timeout(300)

MESH_SHAPES = [{"data": 16, "model": 16},
               {"pod": 2, "data": 16, "model": 16}]
LM_ARCHS = ["qwen2.5-3b", "internlm2-20b", "gemma2-27b", "mixtral-8x22b",
            "moonshot-v1-16b-a3b"]
RECSYS = {"fm": (R.FM, JR.init_fm), "autoint": (R.AutoInt, JR.init_autoint),
          "din": (R.DIN, JR.init_din), "sasrec": (R.SASRec, JR.init_sasrec)}
PNA_FEATS = 1433                      # full_graph_sm's d_feat


class DescribedMesh:
    """A mesh of any size without devices: what both packages read."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


_KEY = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.(\w+)")


def _dotted(path) -> str:
    return ".".join(a or b or c for a, b, c in
                    _KEY.findall(jax.tree_util.keystr(path)))


def _jax_specs(abstract, rules):
    specs = JSH.specs_from_rules(abstract, rules)
    flat, _ = jax.tree_util.tree_flatten_with_path(abstract)
    sflat = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {_dotted(p): (tuple(leaf.shape), tuple(s))
            for (p, leaf), s in zip(flat, sflat)}


def _check(port_specs, port_shapes, jax_specs, jax_name):
    assert set(map(jax_name, port_specs)) == set(jax_specs)
    for name, spec in port_specs.items():
        shape, jspec = jax_specs[jax_name(name)]
        lead = len(shape) - len(port_shapes[name])
        jspec = tuple(jspec) + (None,) * (len(shape) - len(jspec))
        assert shape[lead:] == port_shapes[name], name
        assert jspec[:lead] == (None,) * lead, (name, jspec)
        assert spec == jspec[lead:], (name, spec, jspec)


def _shapes(model):
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


@pytest.fixture(scope="module", params=LM_ARCHS)
def lm(request):
    jcfg = jget_config(request.param)
    cfg = get_config(request.param)
    abstract = jax.eval_shape(
        lambda: jinit_lm(jax.random.key(0), jcfg, dtype=jnp.bfloat16))
    model = DecoderLM(cfg, torch.bfloat16, "meta")
    groups = jax_leaf_groups(cfg, [n for n, _ in model.named_parameters()])
    inverse = {p: j for j, ps in groups.items() for p in ps}
    return cfg, abstract, model, inverse.__getitem__


@pytest.mark.parametrize("mode", ["zero3", "zero1", "dp_all", "opt"])
@pytest.mark.parametrize("mesh_shape", MESH_SHAPES,
                         ids=["data16xmodel16", "pod2xdata16xmodel16"])
def test_lm_param_rules_match_jax(lm, mesh_shape, mode):
    cfg, abstract, model, jax_name = lm
    mesh = DescribedMesh(mesh_shape)
    if mode == "opt":
        rules, jrules = SH.lm_opt_rules(mesh), JSH.lm_opt_rules(mesh)
    else:
        rules = SH.lm_param_rules(mesh, mode)
        jrules = JSH.lm_param_rules(mesh, mode)
    specs = SH.specs_from_rules(model, rules)
    _check(specs, _shapes(model), _jax_specs(abstract, jrules), jax_name)
    # every split divides its dim, so each leaf has a shard shape
    for name, shape in _shapes(model).items():
        SH.shard_shape(shape, specs[name], mesh_shape)
    if mode == "zero3":           # the rules do split the big matrices
        assert specs["embed"] != (None, None)


@pytest.mark.parametrize("mesh_shape", MESH_SHAPES,
                         ids=["data16xmodel16", "pod2xdata16xmodel16"])
def test_gnn_param_rules_match_jax(mesh_shape):
    mesh = DescribedMesh(mesh_shape)
    jcfg, cfg = jget_config("pna"), get_config("pna")
    abstract = jax.eval_shape(
        lambda: JG.init_pna(jax.random.key(0), jcfg, PNA_FEATS))
    model = PNA(cfg, PNA_FEATS, torch.float32, "meta")
    specs = SH.specs_from_rules(model, SH.gnn_param_rules(mesh))
    _check(specs, _shapes(model),
           _jax_specs(abstract, JSH.gnn_param_rules(mesh)),
           lambda n: re.sub(r"^layers\.\d+\.", "layers.", n))
    # d_hidden 75 divides no axis group of the production meshes
    assert all(s == (None, None) for n, s in specs.items()
               if n.startswith("layers.")), specs


@pytest.mark.parametrize("arch", list(RECSYS))
@pytest.mark.parametrize("mesh_shape", MESH_SHAPES,
                         ids=["data16xmodel16", "pod2xdata16xmodel16"])
def test_recsys_param_rules_match_jax(arch, mesh_shape):
    mesh = DescribedMesh(mesh_shape)
    cls, jinit = RECSYS[arch]
    abstract = jax.eval_shape(
        lambda: jinit(jax.random.key(0), jget_config(arch)))
    model = cls(get_config(arch), torch.float32, "meta")
    specs = SH.specs_from_rules(model, SH.recsys_param_rules(mesh))
    _check(specs, _shapes(model),
           _jax_specs(abstract, JSH.recsys_param_rules(mesh)), lambda n: n)
    rows = [s for n, s in specs.items()
            if n.split(".")[-1] in ("table", "linear", "item_table")]
    assert rows and all(s[0] is not None for s in rows), specs


@pytest.mark.parametrize("batch", [1, 128])
@pytest.mark.parametrize("mesh_shape", MESH_SHAPES + [{"model": 4},
                                                      {"data": 1,
                                                       "model": 4}],
                         ids=["data16xmodel16", "pod2xdata16xmodel16",
                              "model4", "data1xmodel4"])
def test_cache_and_batch_specs_match_jax(mesh_shape, batch):
    mesh = DescribedMesh(mesh_shape)
    want = {k: tuple(v) for k, v in JSH.lm_cache_specs(mesh, batch).items()}
    assert SH.lm_cache_specs(mesh, batch) == want
    assert SH.lm_batch_spec(mesh) == tuple(JSH.lm_batch_spec(mesh))
    assert SH.fsdp_axes(mesh) == JSH.fsdp_axes(mesh)
    assert SH.tp_axis(mesh) == JSH.tp_axis(mesh)


def test_shard_shape_and_the_port_mesh():
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    spec = SH.lm_cache_specs(mesh, 2)["k"]
    assert spec == (None, "data", "model", None, None)
    assert SH.shard_shape((36, 2, 524288, 2, 128), spec, mesh.shape) == \
        (36, 1, 131072, 2, 128)
    with pytest.raises(ValueError, match="does not split"):
        SH.shard_shape((3, 8), ("data", None), mesh.shape)
    assert SH.corpus_axes(mesh) == ("data", "model")
    assert SH.corpus_specs(mesh)["embs"] == 0


# ---------------------------------------------------------------------------
# ring collectives
# ---------------------------------------------------------------------------

N = 4


def _noted(monkeypatch):
    hops = []
    monkeypatch.setattr(C, "note_collective",
                        lambda kind, nb: hops.append((kind, nb)))
    return hops


def test_ring_all_gather_matches_jax(monkeypatch):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, 3, 5)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda a: JC.ring_all_gather(a, "x"),
                               axis_name="x")(jnp.asarray(x)))
    mesh = make_mesh((N,), ("x",), device="cpu")
    hops = _noted(monkeypatch)
    parts = [torch.from_numpy(x[s]) for s in range(N)]
    got = C.ring_all_gather(parts, mesh)
    assert len(got) == N
    for s in range(N):
        np.testing.assert_array_equal(got[s].numpy(), want[s])
        assert got[s].data_ptr() != parts[s].data_ptr()
    np.testing.assert_array_equal(got[0].numpy(), x.reshape(N * 3, 5))
    # n - 1 hops, each carrying every shard's chunk
    assert hops == [("collective-permute", N * 3 * 5 * 4)] * (N - 1)


def test_ring_matmul_matches_jax(monkeypatch):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N * 8, 16)).astype(np.float32)
    w = rng.standard_normal((16, 24)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda a, b: JC.ring_matmul(a, b, "x"),
                               in_axes=(0, None), axis_name="x")(
        jnp.asarray(x.reshape(N, 8, 16)), jnp.asarray(w)))
    mesh = make_mesh((N,), ("x",), device="cpu")
    hops = _noted(monkeypatch)
    got = C.ring_matmul([torch.from_numpy(x[s * 8:(s + 1) * 8])
                         for s in range(N)], torch.from_numpy(w), mesh)
    for s in range(N):
        np.testing.assert_allclose(got[s].numpy(), want[s], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(got[s].numpy(), got[0].numpy())
    assert len(hops) == N - 1


def test_ring_collectives_report_to_the_audit_recorder():
    mesh = make_mesh((N,), ("x",), device="cpu")
    parts = [torch.ones(2, 3) * s for s in range(N)]
    with audit.Recorder() as rec:
        C.ring_all_gather(parts, mesh)
    assert rec.collective == {"collective-permute": (N - 1) * N * 2 * 3 * 4}
    assert C.ring_all_gather(parts[:1], make_mesh((1,), ("x",),
                                                  device="cpu"))[0].equal(
        parts[0])
    with pytest.raises(ValueError, match="parts for a mesh"):
        C.ring_all_gather(parts[:3], mesh)
