"""Set-up: process start to the window's start (torch, the CUDA context,
the kernel library, the statement, the warm-up calls)."""


def read(run):
    return run.setup_s
