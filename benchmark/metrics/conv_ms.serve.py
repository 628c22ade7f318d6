"""Device ms an iteration in cuDNN's and cuBLAS's convolution kernels."""
from harness import kernels


def read(rec):
    if rec.kind != "serve" or rec.timeline is None:
        return None
    return rec.per_iteration_ms(kernels.is_conv)
