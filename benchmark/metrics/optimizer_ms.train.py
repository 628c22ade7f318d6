"""Device ms a step in the optimizer phase: the gradient norm, the clip and
fused Adam (`harness/kernels.py::optimizer_spans`)."""
from harness import kernels


def read(rec):
    if rec.kind != "train" or rec.timeline is None:
        return None
    opt = kernels.optimizer_spans(rec.timeline.device)
    if not opt:
        raise RuntimeError("no optimizer phase in the trace")
    return sum(t - s for s, t, _ in rec.timeline.device
               if kernels.in_spans(opt, s)) / 1e3 / rec.timeline.iterations
