"""Col-Bandit on PyTorch and CUDA: the serving path of ``repro`` ported to
one NVIDIA H100.

The package mirrors the module names of the JAX package ``repro`` so each
function has an obvious counterpart there. It imports ``torch``, ``numpy``
and the standard library only. Entry points take ``device=`` (default
``"cuda"``); the hand-written CUDA kernels under ``kernels/csrc`` are built
with ``nvcc`` on first CUDA use, and a CPU tensor takes each kernel's plain
PyTorch version instead.
"""
