"""Multi-pod dry run: a per-device account of EVERY (architecture x input
shape) cell on the production meshes (port of ``repro.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun                # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --both --out results/dryrun.json

JAX lowers and compiles each cell over 512 placeholder devices and reads
XLA's analyses of the HLO module. The port has no HLO: each record is an
account (``analysis/accounting.py``), and its fields are grouped by kind:

  ``exact``     per-device argument and output bytes from the placement
                specs, and JAX's analytic model FLOPs;
  ``counted``   FLOPs (by dtype) and unfused operand + result bytes of the
                port's own step run once on ``meta`` tensors at the cell's
                global shapes (per device: divided by the devices), or of
                one shard's program; None for the retrieval cells, whose
                kernels take no ``meta`` operand;
  ``reckoned``  collective bytes by kind from the specs; for the retrieval
                cells ``kernel_work``, the kernel's work a shard from a
                formula (``launch/steps.py``), with the slots a shard fills
                and its pad slots apart; the three roofline seconds at the
                H100 constants below, the bottleneck and the useful-FLOP
                fraction (model FLOPs over the counted, or for the
                retrieval cells the reckoned, FLOPs).

Nothing is allocated at full size and no card is touched: the production
meshes are described on ``meta``. A cell the account cannot do is a
failure, and the exit code is 1, as in JAX. Constants (one H100 SXM, dense
rates, 700 W; NVIDIA's H100 data sheet and DGX H100 user guide):
989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 outside them
(the port's float32 products run with TF32 off), 3.35 TB/s of HBM; a
collective's group within one host of 8 cards rides NVLink at 450 GB/s
each way, a group across hosts one 400 Gb/s ConnectX-7 port per card, 50
GB/s each way. On the (16, 16) mesh the ``model`` axis of 16 spans two
hosts and ``data`` sixteen, so every production group crosses the NIC.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Dict

from repro_torch.analysis import accounting as A
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.dist import flash_decode as FD
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_cell

DEVICE = "NVIDIA H100 SXM5 80GB"
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12                     # bytes/s
LINK_BW = {"nvlink": 450e9,          # bytes/s each way, within a host
           "nic": 50e9}              # bytes/s each way, one 400 Gb/s port
CONSTANTS = {
    "device": DEVICE, "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
    "link_bw": LINK_BW, "gpus_per_host": A.GPUS_PER_HOST,
    "sources": {
        "peak_flops": "NVIDIA H100 Tensor Core GPU data sheet, SXM, dense: "
                      "989 TFLOP/s bf16/fp16, 67 TFLOP/s fp32 (non-tensor)",
        "hbm_bw": "NVIDIA H100 data sheet, SXM: 80 GB HBM3 at 3.35 TB/s",
        "nvlink": "NVIDIA H100 data sheet: NVLink 900 GB/s per GPU, 450 "
                  "GB/s each way",
        "nic": "NVIDIA DGX H100 user guide: 8 ConnectX-7 400 Gb/s ports, "
               "one per GPU: 50 GB/s each way"},
}

PAPER_ARCHS = ["colbert-text", "colbert-mm"]


def _compute_s(flops_by_dtype: Dict[str, float]) -> float:
    secs = 0.0
    for dtype, f in flops_by_dtype.items():
        if dtype not in PEAK_FLOPS:
            raise ValueError(f"no peak rate for {dtype} FLOPs")
        secs += f / PEAK_FLOPS[dtype]
    return secs


def run_cell(arch: str, shape_name: str, mesh, *, verbose: bool = True,
             **overrides):
    """The account of one cell on ``mesh`` (a record); ``overrides`` go to
    ``build_cell`` (``depth``, ``batch``, ``micro``, ``param_mode``,
    ``flash_decode``, ``corpus_docs``)."""
    t0 = time.perf_counter()
    try:
        cell = build_cell(arch, shape_name, mesh, **overrides)
        ms = dict(mesh.shape)
        n_dev = mesh.size
        counted, work = None, None
        if cell.count is not None:
            _, count = A.count_step(cell.count)
            per = cell.count_devices
            counted = {
                "how": cell.count_how,
                **A.flops_and_bytes(count),
                "flops_by_dtype": count.flops_by_dtype,
                "ops": count.ops,
                "devices_sharing_the_count": per,
                "flops_per_device": count.flops / per,
                "unfused_bytes_per_device": count.unfused_bytes / per,
                "eager_live_peak_bytes_per_device":
                    A.peak_buffer_bytes(count) / per,
                "noted_collective_bytes": count.noted_collective_bytes,
            }
            by_dtype = {k: v / per for k, v in count.flops_by_dtype.items()}
            work_dev = counted
        else:
            w = cell.reckoned_work
            by_dtype = dict(w["flops_by_dtype"])
            work = {
                "how": w["how"],
                "flops_by_dtype": by_dtype,
                "flops_per_device": float(sum(by_dtype.values())),
                "unfused_bytes_per_device": float(w["unfused_bytes"]),
                "kernel_launches_per_device": w["launches"],
                **{k: w[k] for k in ("filled_slots", "pad_slots") if k in w},
            }
            work_dev = work
        mem = A.memory_stats(cell.args, cell.in_specs, cell.outs,
                             cell.out_specs, ms)
    finally:
        FD.configure(None, None, None)
    coll = A.collective_bytes(cell.collectives)
    compute_s = _compute_s(by_dtype)
    memory_s = work_dev["unfused_bytes_per_device"] / HBM_BW
    collective_s, per_link = A.collective_seconds(cell.collectives, ms,
                                                  LINK_BW)
    model_dev = cell.model_flops / n_dev
    flops_dev = work_dev["flops_per_device"]
    t1 = time.perf_counter()
    rec = {
        "arch": arch, "shape": shape_name, "kind": cell.kind,
        "mesh": ms, "n_devices": n_dev, "note": cell.note,
        "method": "account (exact placement bytes, a counted eager run "
                  "or, for the retrieval cells, reckoned kernel work, "
                  "reckoned collectives); no HLO",
        "overrides": overrides,
        "exact": {
            "argument_bytes_per_device": mem["exact_argument_bytes"],
            "output_bytes_per_device": mem["exact_output_bytes"],
            "model_flops": cell.model_flops,
            "model_flops_per_device": model_dev},
        "counted": counted,
        "reckoned": {
            **({"kernel_work": work} if work else {}),
            "collective_bytes_per_device": coll,
            "collective_bytes_by_link": per_link,
            "compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s,
            "useful_flops_frac": model_dev / flops_dev if flops_dev else 0.0},
        "bottleneck": max(
            (("compute", compute_s), ("memory", memory_s),
             ("collective", collective_s)), key=lambda kv: kv[1])[0],
        "account_s": t1 - t0,
    }
    if verbose:
        aa = mem["exact_argument_bytes"] / 2**30
        print(f"  [OK] {arch:22s} {shape_name:15s} args={aa:8.2f}GiB "
              f"T_c={compute_s * 1e3:10.3f}ms T_m={memory_s * 1e3:10.3f}ms "
              f"T_coll={collective_s * 1e3:10.3f}ms -> "
              f"{rec['bottleneck']:10s} useful="
              f"{rec['reckoned']['useful_flops_frac'] * 100:6.1f}% "
              f"({t1 - t0:.1f}s)", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None,
                    help="one arch id (default: all assigned + paper)")
    ap.add_argument("--shape", default=None, help="one shape name")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the (2,16,16) 512-device mesh")
    ap.add_argument("--both", action="store_true",
                    help="run single-pod AND multi-pod")
    ap.add_argument("--out", default=None, help="write JSON records here")
    ap.add_argument("--skip-paper", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ASSIGNED_ARCHS)
    if not args.arch and not args.skip_paper:
        archs += PAPER_ARCHS

    if args.both:
        meshes = [("single-pod", make_production_mesh(multi_pod=False)),
                  ("multi-pod", make_production_mesh(multi_pod=True))]
    else:
        name = "multi-pod" if args.multi_pod else "single-pod"
        meshes = [(name, make_production_mesh(multi_pod=args.multi_pod))]

    t0 = time.perf_counter()
    records, failures = [], []
    for mesh_name, mesh in meshes:
        print(f"=== {mesh_name}: mesh {dict(mesh.shape)} ({mesh.size} "
              f"devices, {DEVICE} constants) ===", flush=True)
        for arch in archs:
            cfg = get_config(arch)
            shapes = ([args.shape] if args.shape
                      else [s.name for s in cfg.shapes])
            for shape_name in shapes:
                try:
                    rec = run_cell(arch, shape_name, mesh)
                    rec["mesh_name"] = mesh_name
                    records.append(rec)
                except Exception as e:           # a failure, reported
                    failures.append((mesh_name, arch, shape_name, str(e)))
                    print(f"  [FAIL] {arch} {shape_name}: {e}", flush=True)
                    traceback.print_exc(limit=3)

    print(f"\n{len(records)} cells accounted, {len(failures)} failures in "
          f"{time.perf_counter() - t0:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"records": records, "failures": failures,
                       "constants": CONSTANTS}, f, indent=1)
        print(f"wrote {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
