"""The host rehearsal of ``src/repro_torch/kernels/csrc/maxsim.cu`` on the CPU.

``sh tools/host_rehearsal/run.sh maxsim`` compiles the CUDA source with
``g++`` (each block as host threads, ``__syncthreads`` a barrier of the
block, ``cp.async`` a checked synchronous copy) and holds all four entry
points to a serial fmaf-chain reference bit for bit: the dense ones on 8
cases, the masked ones on the same 8 under a random and a patterned tile
mask against where(tile, reference, 0), residual codebooks too large to
stage among them (read from global memory). A barrier that not every thread
reaches hangs it, as on the card, so the timeout catches that too. It says
nothing of speed. Skips only where ``g++`` is absent.
"""
import shutil
import subprocess
from pathlib import Path

import pytest
from test_torch_threads import cap_torch_threads

cap_torch_threads()

ROOT = Path(__file__).resolve().parents[1]


def test_maxsim_host_rehearsal_is_bit_equal():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the host rehearsal")
    run = subprocess.run(["sh", "tools/host_rehearsal/run.sh", "maxsim"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "maxsim rehearsal ok" in run.stdout
    assert "codebook in global memory in 2 cases (want 2)" in run.stdout
