"""Model FLOPs a second over the whole window (`harness/shapes.py`:
convolutions and heads; a train step counts three forwards), as a share of
the configuration's peak (`harness/peaks.py`), in %."""
from harness import peaks, shapes


def read(rec):
    if rec.kind != "serve" or rec.timeline is None:
        return None
    rate = rec.flops_per_iteration() * rec.iterations / rec.window_s
    return 100.0 * rate / peaks.OPS_PER_S[shapes.peak_type(rec.cfg)]
