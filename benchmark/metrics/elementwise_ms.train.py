"""Device ms a step in torch's own kernels besides convolutions (batch norm's
float32 math and its gradient, ReLU, adds, casts, copies, reductions),
outside the optimizer phase."""
from harness import kernels


def read(rec):
    if rec.kind != "train" or rec.timeline is None:
        return None
    opt = kernels.optimizer_spans(rec.timeline.device)
    return sum(t - s for s, t, n in rec.timeline.device
               if kernels.is_torch_other(n) and not kernels.in_spans(opt, s)) \
        / 1e3 / rec.timeline.iterations
