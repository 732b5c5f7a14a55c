"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded through ``ctypes``.
The build runs at the first CUDA launch, never at import, with one ``nvcc``
process per source, all started together. Libraries land in
``build/kernels/`` at the repository root, named by a hash of the sources
and flags, so an unchanged tree reuses them; a finished library is moved
into place atomically, so concurrent processes never load a partial file.

``LAUNCHES`` counts, per kernel, the launches its wrapper made and those
a CUDA graph replays (:func:`add_launches`); callers reset it with
:func:`reset_launches` to show that a run went through the kernels. Both
the library cache and the counts are shared by every thread of the
process (the async serving engine launches from its own threads),
so each is changed under a lock: concurrent first uses build and load a
library once, and no launch goes uncounted.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("reveal.cu", "maxsim.cu")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# The compressed corpus's leading arguments: data, scales, codes, codebook
# (both None for int8), Kc.
_QUANT = [_P, _P, _P, _P, _I]
# C signature of every entry point, by library: (name, argtypes), and
# (name, argtypes, restype) where it returns other than an int status.
# The reveal entry points end in (..., block_l, stream) and the dense maxsim
# ones in (..., block_n, stream): the launch shape, a tunable argument
# (kernels/tuning.py), which no cell's value depends on.
_ENTRY_POINTS = {
    "reveal.cu": (
        ("colbandit_reveal_smem_bytes", [_I, _I, _I, _I, _I, _I, _I, _I],
         _LL),
        ("colbandit_fused_reveal",
         [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _I, _I,
          _I, _P]),
        ("colbandit_gather_maxsim",
         [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _I, _I, _I, _P]),
        ("colbandit_fused_reveal_q",
         _QUANT + [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _I,
                   _I, _I, _P]),
        ("colbandit_gather_maxsim_q",
         _QUANT + [_P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _I, _I, _I,
                   _P]),
    ),
    "maxsim.cu": (
        ("colbandit_maxsim_smem_bytes", [_I, _I, _I, _I, _I, _I], _LL),
        ("colbandit_maxsim",
         [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
        ("colbandit_maxsim_q",
         _QUANT + [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
        ("colbandit_masked_maxsim",
         [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
        ("colbandit_masked_maxsim_q",
         _QUANT + [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    ),
}

LAUNCHES: Dict[str, int] = {"maxsim": 0, "fused_reveal": 0,
                            "gather_maxsim": 0, "maxsim_q": 0,
                            "fused_reveal_q": 0, "gather_maxsim_q": 0,
                            "masked_maxsim": 0, "masked_maxsim_q": 0}
# Loaded libraries by source name, and the nvcc report of the last build.
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}
# Guards _LIBS (build, load and register a library once) and LAUNCHES.
_LIB_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    """A copy of ``LAUNCHES``, read under its lock."""
    with _COUNT_LOCK:
        return dict(LAUNCHES)


def add_launches(counts: Dict[str, int], times: int = 1) -> None:
    """Count ``counts`` launches ``times`` over: a CUDA graph's captured
    launches at each replay, which passes no wrapper."""
    if not counts:
        return
    with _COUNT_LOCK:
        for name, n in counts.items():
            LAUNCHES[name] += n * times


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built from source at first use")
    return found


def _lib_path(source: str) -> Path:
    h = hashlib.sha256()
    for part in (source, *sorted(p.name for p in CSRC.glob("*.cuh"))):
        h.update(part.encode())
        h.update((CSRC / part).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Optional[List[str]] = None) -> float:
    """Compile every missing library, one nvcc per source in parallel.
    Returns the seconds spent; raises RuntimeError on a compiler error."""
    t0 = time.perf_counter()
    todo = [s for s in (sources or SOURCES) if not _lib_path(s).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(CSRC / src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, tmp, proc in procs:
        out, _ = proc.communicate()
        BUILD_LOG[src] = out
        if proc.returncode != 0:
            failed.append(f"{src}:\n{out}")
            os.unlink(tmp)
        else:
            os.replace(tmp, _lib_path(src))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _LIBS.get(source)
    if lib is not None:
        return lib
    with _LIB_LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(_lib_path(source)))
            for name, argtypes, *restype in _ENTRY_POINTS[source]:
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype[0] if restype else ctypes.c_int
            _LIBS[source] = lib
    return lib


def check_launch(status: int, kernel: str) -> None:
    """Raise on a nonzero ``cudaGetLastError`` from a launch, then count
    the launch."""
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error "
                           f"{status}")
    with _COUNT_LOCK:
        LAUNCHES[kernel] += 1


def require_cuda(kernel: str, *tensors: torch.Tensor) -> torch.device:
    """The one CUDA device all operands of a launch share."""
    devices = {t.device for t in tensors}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{kernel}: the CUDA kernel needs every operand on "
                         f"one CUDA device, got {sorted(map(str, devices))}")
    return next(iter(devices))


def require(cond: bool, kernel: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{kernel}: {msg}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


FLOAT_TYPES = (torch.float32, torch.bfloat16)
SHARED_MEM_BYTES = 227 * 1024


def quant_args(kernel: str, qt) -> Tuple[list, int]:
    """Validate the leaves of a ``QuantTokens`` operand of a ``_q`` kernel:
    data int8 (..., L, M), scales (..., L) bf16 or f32, and for the
    residual format codes (..., L) int32 plus a (Kc, M) f32 codebook, all
    contiguous. Returns the C arguments (data, scales, codes, codebook, Kc)
    and whether the scales are bf16. The caller checks devices."""
    data, scales, codes, codebook = qt
    require(data.dtype == torch.int8 and data.dim() >= 2, kernel,
            f"data must be an int8 (..., L, M) tensor, got {data.dtype} "
            f"{tuple(data.shape)}")
    require(scales.dtype in (torch.bfloat16, torch.float32)
            and tuple(scales.shape) == tuple(data.shape[:-1]), kernel,
            f"scales must be bfloat16/float32 shaped {tuple(data.shape[:-1])}"
            f", got {scales.dtype} {tuple(scales.shape)}")
    require((codes is None) == (codebook is None), kernel,
            "codes and codebook come together (residual) or not at all "
            "(int8)")
    leaves = [data, scales]
    kc = 0
    if codes is not None:
        require(codes.dtype == torch.int32
                and tuple(codes.shape) == tuple(data.shape[:-1]), kernel,
                f"codes must be int32 shaped {tuple(data.shape[:-1])}, got "
                f"{codes.dtype} {tuple(codes.shape)}")
        require(codebook.dtype == torch.float32 and codebook.dim() == 2
                and codebook.shape[0] >= 1
                and codebook.shape[1] == data.shape[-1], kernel,
                f"codebook must be float32 (Kc, M={data.shape[-1]}), got "
                f"{codebook.dtype} {tuple(codebook.shape)}")
        leaves += [codes, codebook]
        kc = codebook.shape[0]
    require(all(t.is_contiguous() for t in leaves), kernel,
            "quantized leaves must be contiguous")
    ptrs = [t.data_ptr() for t in leaves] + [None] * (4 - len(leaves))
    return ptrs + [kc], int(scales.dtype == torch.bfloat16)
