"""Every cell, traffic mix and metric is found by name, and a new one is
new files and entries only; nothing the benchmark runs imports JAX or the
JAX package, and the reference imports nothing of the program."""
import ast
import json
import shutil
from pathlib import Path

import pytest

from perfbench.harness import guard, spec

BENCH = spec.BENCH
SPEC = spec.benchmark()


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_loads_by_name(name):
    cell = spec.cell(name)
    assert cell.workload["limits"] and cell.chips == 1
    assert spec.loop(cell.traffic["loop"]).run
    assert {"setup_s"} < {m["name"] for m in cell.end_to_end}
    assert cell.per_layer
    for m in cell.per_layer:
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        assert "workloads" not in moved or name in moved["workloads"]


@pytest.mark.parametrize("name", sorted(p.stem for p in
                                        (BENCH / "workloads").glob("*.json")))
def test_every_workload_file_is_a_cell(name):
    assert name in {w["name"] for w in SPEC["workloads"]}


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"]
                                    + SPEC["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(metric).read)


def test_metric_files_are_metrics():
    names = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    assert {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")} == names


def test_new_cell_needs_no_edit(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a cell and a
    metric by new files and appended entries alone."""
    root = tmp_path / "co"
    shutil.copytree(BENCH, root / "perfbench")
    doc = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*")
              if p.is_file()}
    b = root / "perfbench"
    conf = json.loads((b / "configs" / "colbert-text.json").read_text())
    (b / "configs" / "colbert-small.json").write_text(json.dumps(
        dict(conf, name="colbert-small", n_docs=8192)))
    (b / "traffic" / "closed8.json").write_text(json.dumps(
        {"loop": "closed_loop", "outstanding": 8, "candidates": 64,
         "k": 5, "query_pool": 64}))
    wl = json.loads((b / "workloads" / "text-dense-64.json").read_text())
    (b / "workloads" / "small-dense.json").write_text(json.dumps(
        dict(wl, config="colbert-small", traffic="closed8")))
    (b / "metrics" / "batches.qps.py").write_text(
        "def read(run):\n    return len(run.batches)\n")
    doc["configs"].append({"name": "colbert-small", "source": "x",
                           "file": "perfbench/configs/colbert-small.json",
                           "reduced": [], "why": "x"})
    doc["workloads"].append({"name": "small-dense", "config": "colbert-small",
                             "traffic": "closed8", "chips": 1, "why": "x"})
    doc["per_layer"].append({"name": "batches.qps", "unit": "n",
                             "better": "higher", "source": "program_counter",
                             "layer": "engine (serve/engine.py)",
                             "moves": "qps"})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    cell = spec.cell("small-dense", root=root, bench=b)
    assert cell.config["n_docs"] == 8192 and cell.traffic["outstanding"] == 8
    assert "batches.qps" in {m["name"] for m in cell.per_layer}
    assert spec.reader("batches.qps", bench=b).read(
        type("R", (), {"batches": [1, 2]})()) == 2
    after = {p: p.read_bytes() for p in before}
    assert after == before                      # no file was edited


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules(["repro_torch", "repro_torch.serve",
                                    "reprox", "jaxtyping", "torch"]) == []
    assert guard.forbidden_modules(["repro.core", "jax._src",
                                    "flax"]) == ["flax", "jax", "repro"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {guard.top_level(m) for m in _imports(path)}
        assert not tops & set(guard.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {guard.top_level(m) for m in _imports(path)}
        assert tops <= {"__future__", "contextlib", "typing", "torch",
                        "perfbench"}, (path, tops)
        for m in _imports(path):
            if guard.top_level(m) == "perfbench":
                assert m.startswith("perfbench.reference"), (path, m)
