"""Trigger fixture for kernel-assert: a bare assert in a kernels/
directory (stripped under ``python -O``; a kernel wrapper raises
ValueError at its host entry point instead)."""


def launch(n: int, bn: int):
    assert n % bn == 0, (n, bn)                        # kernel-assert
    return n // bn
