#!/usr/bin/env python3
"""nvcc build seconds of the CUDA sources of two or more checkouts, in turns.

Each round compiles every source of ``src/repro_torch/kernels/csrc`` of one
checkout the way ``kernels/_build.py::build`` does (its own flags, one nvcc
per source, all started together) into a fresh temporary directory, and
records each source's seconds and the wall time of the round (what
``chip_smoke.py`` phase 2 waits for). Checkouts run in the order given,
then reversed (``parent tree`` gives parent, tree, tree, parent), so drift
on the machine falls on both alike.

    python3 tools/build_seconds.py parent=build/parent tree=.

Prints one line per round and a JSON summary (median seconds per source
and round, per checkout). Needs nvcc (the chip machine).
"""
import importlib.util
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def _build_module(root: Path):
    path = root / "src" / "repro_torch" / "kernels" / "_build.py"
    spec = importlib.util.spec_from_file_location(f"_build_{id(path)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one_round(root: Path) -> dict:
    """Seconds per source and the round's wall time for one checkout."""
    b = _build_module(root)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = []
        for src in b.SOURCES:
            cmd = [b._nvcc(), *b.NVCC_FLAGS, "-I", str(b.CSRC), "-o",
                   str(Path(tmp) / f"{src}.so"), str(b.CSRC / src)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        pending = dict(procs)
        while pending:
            for src, p in list(pending.items()):
                if p.poll() is not None:
                    log = p.communicate()[0]
                    if p.returncode:
                        sys.exit(f"{root}: nvcc failed on {src}:\n{log}")
                    out[src] = time.perf_counter() - t0
                    del pending[src]
            time.sleep(0.05)
        out["round"] = time.perf_counter() - t0
    return out


def main(argv) -> int:
    pairs = [a.split("=", 1) for a in argv]
    if not pairs or any(len(p) != 2 for p in pairs):
        sys.exit(__doc__)
    order = pairs + pairs[::-1]
    runs = {name: [] for name, _ in pairs}
    for name, path in order:
        r = one_round(Path(path).resolve())
        runs[name].append(r)
        print(f"build {name}: " + ", ".join(f"{k} {v:.1f} s"
                                            for k, v in r.items()),
              flush=True)
    summary = {name: {k: statistics.median(r[k] for r in rs)
                      for k in rs[0]} for name, rs in runs.items()}
    print("build_seconds " + json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
