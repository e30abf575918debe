"""Seconds from the process's start to the window: imports, the CUDA
context, the deployment's data, the program's index and kernels, the
warm-up job."""


def read(ctx):
    return ctx["setup_s"]
