"""Model FLOPs a second over the whole window, as a share of the
configuration's peak (`harness/peaks.py`), in %: the FLOPs of the
configuration's reference (`reference/metro_effv2.py::forward_flops`: every
convolution, the depthwise and squeeze-excitation ones included, and both
heads, two a multiply-add) over the rows of each batch. A reference without
a FLOP count reads None."""
from harness import peaks, shapes, spec


def read(rec):
    if rec.kind != "serve" or rec.timeline is None:
        return None
    ref = spec.reference(rec.cfg)
    if not hasattr(ref, "forward_flops"):
        return None
    flops = ref.forward_flops(rec.cfg) * shapes.rows(rec.cfg, rec.traffic) * rec.iterations
    return 100.0 * flops / rec.window_s / peaks.OPS_PER_S[shapes.peak_type(rec.cfg)]
