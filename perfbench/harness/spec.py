"""Find a cell and everything it names, by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics. A
cell's own file, ``workloads/<cell>.json``, holds its engine settings,
check sizes and limits; ``configs/<config>.json`` the configuration's
sizes; ``traffic/<traffic>.json`` the traffic mix, whose ``loop`` names the
generator ``traffic/<loop>.py``; ``metrics/<metric>.py`` the reader of one
metric. Adding any of them adds files and entries and edits none.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    workload: dict       # workloads/<cell>.json
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT, bench: Path = BENCH) -> Cell:
    spec = benchmark(root)
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    entry = entries[name]
    workload = _json(bench / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json's {key} "
                             f"{workload[key]!r} != BENCHMARK.json's "
                             f"{entry[key]!r}")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    return Cell(name=name, entry=entry, workload=workload,
                config=_json(root / conf["file"]),
                traffic=_json(bench / "traffic" / f"{entry['traffic']}.json"),
                end_to_end=[m for m in spec["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in spec["per_layer"] if _reports(m, name)])


def loop(kind: str) -> ModuleType:
    """The traffic generator ``traffic/<kind>.py``."""
    return importlib.import_module(f"perfbench.traffic.{kind}")


_READERS: Dict[str, ModuleType] = {}


def reader(metric: str, bench: Path = BENCH) -> ModuleType:
    """The reader ``metrics/<metric>.py`` (names may hold dots)."""
    mod: Optional[ModuleType] = _READERS.get(metric)
    if mod is None:
        path = bench / "metrics" / f"{metric}.py"
        s = importlib.util.spec_from_file_location(
            "perfbench_metric_" + metric.replace(".", "__"), path)
        if s is None or not path.exists():
            raise FileNotFoundError(f"no reader {path}")
        mod = importlib.util.module_from_spec(s)
        s.loader.exec_module(mod)
        _READERS[metric] = mod
    return mod
