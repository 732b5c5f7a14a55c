#!/usr/bin/env python3
"""Time variants of the MaxSim kernel source against each other on one card.

    python3 tools/maxsim_variants.py                       # the tree alone
    python3 tools/maxsim_variants.py \\
        'docs1=constexpr int kDocs = 2;=>constexpr int kDocs = 1;' \\
        'old=@path/to/another/csrc/maxsim.cu'

Each argument NAME=OLD=>NEW builds a copy of ``csrc/maxsim.cu`` with the
text OLD replaced by NEW (several substitutions for one name are separated
by ' && '); NAME=@PATH builds the file at PATH instead, with the headers
beside it (so the ``csrc/`` of another checkout builds as it was). The
tree's own source is the variant "tree". All copies are built by ``nvcc``
in parallel into ``build/variants/`` (ptxas registers and spills are
printed per instantiation), then the wrappers run with ``_build``'s loaded
library swapped per variant: ``maxsim`` (f32) and ``maxsim_q`` (int8,
residual with 8 centroids) at the serving shape (B = 16, N = 256), and
over 65,536 docs of one query (chip_smoke.py's phase 6(b)) the same dense
kernels and ``masked_maxsim`` / ``masked_maxsim_q`` at tile densities 0,
0.1, 0.4 and 1 (bn = bt = 8, seeded masks); L = M = 128, T = 32, doc
lengths uniform in 32..128. Variants are timed in turns (tree, a, b, ...,
b, a, tree): device ms per launch from the profiler's records, L2 flushed
before each launch. Every variant's output must equal the tree's bit for
bit. Needs a CUDA card and ``nvcc``.
"""
import ctypes
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.masked_maxsim import masked_maxsim_cuda, \
    masked_maxsim_q_cuda  # noqa: E402
from repro_torch.kernels.maxsim import maxsim_batch_cuda, \
    maxsim_batch_q_cuda  # noqa: E402
from repro_torch.kernels.quant import corpus_reshape, quantize  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

OUT = ROOT / "build" / "variants"
DENSITIES = (0.0, 0.1, 0.4, 1.0)
BN = 8


def parse(args):
    variants = {"tree": _build.CSRC / "maxsim.cu"}
    for arg in args:
        name, _, spec = arg.partition("=")
        if spec.startswith("@"):
            variants[name] = Path(spec[1:]).resolve()
        else:
            variants[name] = [tuple(s.split("=>", 1))
                              for s in spec.split(" && ")]
    return variants


def build(variants):
    """One library per variant, built in parallel; prints ptxas lines."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "maxsim.cu").read_text()
    procs = {}
    for name, spec in variants.items():
        if isinstance(spec, Path):
            # Copy the source with its headers, so its includes resolve to
            # the files it was written against.
            d = OUT / f"maxsim_{name}"
            d.mkdir(exist_ok=True)
            for f in [spec, *spec.parent.glob("*.cuh")]:
                shutil.copy(f, d / f.name)
            path = d / "maxsim.cu"
        else:
            text = src
            for old, new in spec:
                if old not in text:
                    sys.exit(f"{name}: {old!r} is not in maxsim.cu")
                text = text.replace(old, new)
            path = OUT / f"maxsim_{name}.cu"
            path.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(OUT / f"maxsim_{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"{name}: nvcc failed\n{out}")
        fn, spill = "?", ""
        for line in out.splitlines():
            if "Function properties for" in line:
                mangled = line.split("Function properties for")[-1].strip()
                fn = subprocess.run(["c++filt", mangled], capture_output=True,
                                    text=True).stdout.strip()
                fn = fn.replace("(anonymous namespace)::", "").split("(")[0]
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                print(f"ptxas {name}: {fn}: {spill}; "
                      f"{line.split(':', 1)[-1].strip()}")
        lib = ctypes.CDLL(str(OUT / f"maxsim_{name}.so"))
        for entry, argtypes, *restype in _build._ENTRY_POINTS["maxsim.cu"]:
            f = getattr(lib, entry)
            f.argtypes = argtypes
            f.restype = restype[0] if restype else ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("maxsim_variants: needs a CUDA card")
    libs = build(parse(sys.argv[1:]))
    names = list(libs)
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
            sys.exit(f"{sum(x.count for x in recs)} records of {body} for "
                     f"{n} launches")
        return sum(x.self_device_time_total for x in recs) / 1e3 / n

    gen = torch.Generator(device="cuda").manual_seed(0)
    L, M, T = 128, 128, 32
    for label, B, N, n in (("serving", 16, 256, 20), ("bulk", 1, 65536, 5)):
        e = torch.randn((B * N, L, M), generator=gen, device="cuda")
        e = e / e.norm(dim=-1, keepdim=True)
        lens = torch.randint(32, L + 1, (B * N,), generator=gen,
                             device="cuda")
        m = (torch.arange(L, device="cuda")[None] < lens[:, None])
        m = m.contiguous()
        q = torch.randn((B, T, M), generator=gen, device="cuda")
        q = q / q.norm(dim=-1, keepdim=True)
        cb = torch.randn((8, M), generator=gen, device="cuda")
        cb = cb / cb.norm(dim=-1, keepdim=True)
        corpora = {"f32": e, "int8": quantize(e, "int8"),
                   "residual": quantize(e, "residual", codebook=cb)}
        del e
        tms = {d: torch.rand((-(-N // BN), T // BN), generator=gen,
                             device="cuda") < d for d in DENSITIES}
        for fmt, c in corpora.items():
            quant = fmt != "f32"
            rows = "QuantRows" if quant else "DenseRows"
            dense = maxsim_batch_q_cuda if quant else maxsim_batch_cuda
            masked = masked_maxsim_q_cuda if quant else masked_maxsim_cuda
            cases = {"dense": (
                lambda: dense(corpus_reshape(c, B, N), m.reshape(B, N, L),
                              q), "maxsim_kernel<" + rows)}
            if B == 1:
                for d, tm in tms.items():
                    cases[f"masked d={d}"] = (
                        lambda tm=tm: masked(c, m, q[0], tm, BN, BN),
                        "masked_maxsim<" + rows)
            for case, (fn, body) in cases.items():
                res = {k: [] for k in names}
                ref = None
                for k in names + names[::-1]:
                    _build._LIBS["maxsim.cu"] = libs[k]
                    out = fn()
                    if ref is None:
                        ref = out
                    elif not torch.equal(ref, out):
                        sys.exit(f"{label} {fmt} {case}: {k} differs from "
                                 "tree")
                    res[k].append(device_ms(fn, body, n))
                print(f"{label} B={B} N={N} {fmt} {case}: device ms per "
                      "launch " + "; ".join(
                          f"{k} {[round(x, 5) for x in v]}"
                          for k, v in res.items()), flush=True)
        del corpora
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
