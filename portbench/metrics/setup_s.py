"""setup_s (s): process start to the first timed call, on the host's clock.

Import, the CUDA context, the kernels' load (nvcc in a checkout's first
run), the inputs made on the device, the reference fit and the warm-up of
the cell's own shapes.
"""


def read(run):
    return run.setup_s
