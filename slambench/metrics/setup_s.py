"""setup_s: process start to window start: imports, CUDA start, kernels
loaded (built on the first run of a checkout), the log made, written and
read, the SLAM built, and the cell's prefix or warm-up."""


def read(run):
    return run.setup_s
