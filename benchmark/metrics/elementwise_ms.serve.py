"""Device ms a batch in torch's own kernels besides convolutions: batch
norm's float32 math, ReLU, adds, casts, copies, reductions, softmax."""
from harness import kernels


def read(rec):
    if rec.kind != "serve" or rec.timeline is None:
        return None
    return rec.per_iteration_ms(kernels.is_torch_other)
