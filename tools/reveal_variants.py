#!/usr/bin/env python3
"""Time variants of the reveal kernel against each other on one card.

    python3 tools/reveal_variants.py                       # the tree alone
    python3 tools/reveal_variants.py \\
        'loose=using Narrow = Shape<128, 32, 2, 6>;=>using Narrow = Shape<128, 32, 2, 4>;'

Each argument NAME=OLD=>NEW builds a copy of ``csrc/reveal.cu`` with the
text OLD replaced by NEW (several substitutions for one name are separated
by ' && '); the tree's own source is the variant "tree". All copies are
built by ``nvcc`` in parallel into ``build/variants/`` (ptxas registers and
spills are printed per instantiation), then the four reveal entry points
run through their wrappers (``_build``'s loaded library swapped per
variant) at the round (F=128, G=8) and init (F=4096, G=1) shapes on a
4,096-doc corpus, L = M = 128, f32 and int8. Variants are timed in turns
(tree, a, b, ..., b, a, tree): cold device ms per launch from the
profiler's records with L2 flushed before each of 20 launches, and
back-to-back CUDA-event ms per call. Every variant's output must equal the
tree's bit for bit. Needs a CUDA card and ``nvcc``.
"""
import ctypes
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.gather_maxsim import gather_maxsim_cuda, \
    gather_maxsim_q_cuda  # noqa: E402
from repro_torch.kernels.quant import quantize  # noqa: E402
from repro_torch.kernels.reveal import fused_reveal_cuda, \
    fused_reveal_q_cuda  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

OUT = ROOT / "build" / "variants"


def parse(args):
    variants = {"tree": []}
    for arg in args:
        name, _, subs = arg.partition("=")
        variants[name] = [tuple(s.split("=>", 1)) for s in subs.split(" && ")]
    return variants


def build(variants):
    """One library per variant, built in parallel; prints ptxas lines."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "reveal.cu").read_text()
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                sys.exit(f"{name}: {old!r} is not in reveal.cu")
            text = text.replace(old, new)
        path = OUT / f"reveal_{name}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(OUT / f"{name}.so"), str(path)],
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
                fn = fn[fn.find("reveal_kernel<"):].split("(")[0]
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                print(f"ptxas {name}: {fn}: {spill}; "
                      f"{line.split(':', 1)[-1].strip()}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        for entry, argtypes, *restype in _build._ENTRY_POINTS["reveal.cu"]:
            f = getattr(lib, entry)
            f.argtypes = argtypes
            f.restype = restype[0] if restype else ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("reveal_variants: needs a CUDA card")
    variants = parse(sys.argv[1:])
    libs = build(variants)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {smi}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    D, L, M, TQ = 4096, 128, 128, 512
    e = torch.randn((D, L, M), generator=gen, device="cuda")
    e = e / e.norm(dim=-1, keepdim=True)
    lens = torch.randint(32, L + 1, (D,), generator=gen, device="cuda")
    m = (torch.arange(L, device="cuda")[None] < lens[:, None]).contiguous()
    qt8 = quantize(e, "int8")
    q = torch.randn((TQ, M), generator=gen, device="cuda")
    q = q / q.norm(dim=-1, keepdim=True)
    flush = torch.empty(2 ** 25, device="cuda")   # twice the 50 MB L2

    def device_ms(fn, n=20):
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
                if x.device_type == DeviceType.CUDA
                and "reveal_kernel" in x.key]
        if sum(x.count for x in recs) != n:
            sys.exit(f"{sum(x.count for x in recs)} records for {n} launches")
        return sum(x.self_device_time_total for x in recs) / 1e3 / n

    def event_ms(fn, n=20, reps=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / n)
        return statistics.median(times)

    names = list(variants)
    order = names + names[::-1]
    for F, G in ((128, 8), (4096, 1)):
        sets = [(torch.randint(0, D, (F,), generator=gen, device="cuda"),
                 torch.randint(0, TQ, (F, G), generator=gen, device="cuda"),
                 torch.rand((F, G), generator=gen, device="cuda") < 0.7)
                for _ in range(8)]
        it = [0]

        def nxt():
            it[0] += 1
            return sets[it[0] % len(sets)]

        kernels = {
            "fused_reveal": lambda: fused_reveal_cuda(e, m, q, *nxt()),
            "gather_maxsim": lambda: gather_maxsim_cuda(e, m, q,
                                                        *nxt()[:2]),
            "fused_reveal_q int8": lambda: fused_reveal_q_cuda(qt8, m, q,
                                                               *nxt()),
            "gather_maxsim_q int8": lambda: gather_maxsim_q_cuda(
                qt8, m, q, *nxt()[:2])}
        for kname, fn in kernels.items():
            res = {n: [] for n in names}
            ref = None
            for name in order:
                _build._LIBS["reveal.cu"] = libs[name]
                it[0] = 0
                out = fn()
                out = out[0] if isinstance(out, tuple) else out
                if ref is None:
                    ref = out
                elif not torch.equal(ref, out):
                    sys.exit(f"{kname} F={F}: {name} differs from tree")
                res[name].append((device_ms(fn), event_ms(fn)))
            print(f"F={F} G={G} {kname}: " + "; ".join(
                f"{n} cold device ms {[round(a, 5) for a, _ in v]} "
                f"event ms {[round(b, 5) for _, b in v]}"
                for n, v in res.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
