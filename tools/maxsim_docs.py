#!/usr/bin/env python3
"""Time the dense MaxSim kernel at 1, 2 and 4 docs per block on one card.

    python3 tools/maxsim_docs.py

Builds three copies of ``csrc/maxsim.cu`` that differ only in ``kDocs``
(docs per block), in parallel with ``nvcc`` into ``build/variants/``
(ptxas registers and spills are printed per dense instantiation), then runs
``maxsim`` (f32) and ``maxsim_q`` (int8, residual with 8 centroids)
through their wrappers, with ``_build``'s loaded library swapped per copy,
at the serving shape (B = 16, N = 256) and over 65,536 docs of one query
(the bulk shape of chip_smoke.py's phase 6(b)); L = M = 128, T = 32, doc
lengths uniform in 32..128. Copies are timed in turns (1, 2, 4, 4, 2, 1):
device ms per launch from the profiler's records, L2 flushed before each
launch. Every copy's output must equal the first one's bit for bit. Needs
a CUDA card and ``nvcc``.
"""
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.maxsim import maxsim_batch_cuda, \
    maxsim_batch_q_cuda  # noqa: E402
from repro_torch.kernels.quant import corpus_reshape, quantize  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

OUT = ROOT / "build" / "variants"
DOCS = (1, 2, 4)
KNOB = "constexpr int kDocs = 2;"


def build():
    """One library per kDocs, built in parallel; prints ptxas lines."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "maxsim.cu").read_text()
    if KNOB not in src:
        sys.exit(f"{KNOB!r} is not in maxsim.cu")
    procs = {}
    for k in DOCS:
        path = OUT / f"maxsim_docs{k}.cu"
        path.write_text(src.replace(KNOB, f"constexpr int kDocs = {k};"))
        procs[k] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(OUT / f"maxsim_docs{k}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for k, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"kDocs={k}: nvcc failed\n{out}")
        fn, spill = "?", ""
        for line in out.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line and "maxsim_kernel" in fn:
                name = subprocess.run(["c++filt", fn], capture_output=True,
                                      text=True).stdout.strip()
                name = name[name.find("maxsim_kernel<"):].split("(")[0]
                print(f"ptxas kDocs={k}: {name}: {spill}; "
                      f"{line.split(':', 1)[-1].strip()}")
        lib = ctypes.CDLL(str(OUT / f"maxsim_docs{k}.so"))
        for entry, argtypes, *restype in _build._ENTRY_POINTS["maxsim.cu"]:
            f = getattr(lib, entry)
            f.argtypes = argtypes
            f.restype = restype[0] if restype else ctypes.c_int
        libs[k] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("maxsim_docs: needs a CUDA card")
    libs = build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    flush = torch.empty(2 ** 25, device="cuda")   # twice the 50 MB L2

    def device_ms(fn, body, n):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(512):        # take the profile's first-record loss
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            for _ in range(n):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        recs = [x for x in prof.key_averages()
                if x.device_type == DeviceType.CUDA and body in x.key]
        if sum(x.count for x in recs) != n:
            sys.exit(f"{sum(x.count for x in recs)} records for {n} launches")
        return sum(x.self_device_time_total for x in recs) / 1e3 / n

    gen = torch.Generator(device="cuda").manual_seed(0)
    L, M, T = 128, 128, 32
    for label, B, N, n in (("serving", 16, 256, 20), ("bulk", 1, 65536, 5)):
        e = torch.randn((B * N, L, M), generator=gen, device="cuda")
        e = e / e.norm(dim=-1, keepdim=True)
        lens = torch.randint(32, L + 1, (B * N,), generator=gen,
                             device="cuda")
        m = (torch.arange(L, device="cuda")[None] < lens[:, None])
        m = m.reshape(B, N, L).contiguous()
        q = torch.randn((B, T, M), generator=gen, device="cuda")
        q = q / q.norm(dim=-1, keepdim=True)
        cb = torch.randn((8, M), generator=gen, device="cuda")
        cb = cb / cb.norm(dim=-1, keepdim=True)
        corpora = {"f32": e.reshape(B, N, L, M),
                   "int8": corpus_reshape(quantize(e, "int8"), B, N),
                   "residual": corpus_reshape(
                       quantize(e, "residual", codebook=cb), B, N)}
        del e
        for fmt, c in corpora.items():
            if fmt == "f32":
                fn, body = (lambda: maxsim_batch_cuda(c, m, q),
                            "maxsim_kernel<DenseRows")
            else:
                fn, body = (lambda: maxsim_batch_q_cuda(c, m, q),
                            "maxsim_kernel<QuantRows")
            res = {k: [] for k in DOCS}
            ref = None
            for k in DOCS + DOCS[::-1]:
                _build._LIBS["maxsim.cu"] = libs[k]
                out = fn()
                if ref is None:
                    ref = out
                elif not torch.equal(ref, out):
                    sys.exit(f"{label} {fmt}: kDocs={k} differs from "
                             f"kDocs={DOCS[0]}")
                res[k].append(device_ms(fn, body, n))
            print(f"{label} B={B} N={N} {fmt}: device ms per launch "
                  + "; ".join(f"kDocs={k} {[round(x, 5) for x in v]}"
                              for k, v in res.items()), flush=True)
        del corpora
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
