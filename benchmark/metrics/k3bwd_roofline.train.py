"""Share of its roofline (`benchmark/rooflines/k3bwd.py`) that the stem max pool's backward
reaches in the trace, in %."""


def read(rec):
    if rec.kind != "train" or rec.timeline is None:
        return None
    return rec.roofline_share("k3bwd")
