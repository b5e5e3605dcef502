"""Set-up: process start to the first timed request (imports, the kernels'
build or load, the program's modules, the input pool, capture and warm-up)."""


def read(run):
    return run.setup_s
