"""Share of its roofline (`benchmark/rooflines/k2.py`) that the occluder paste (K2)
reaches in the trace, in %."""


def read(rec):
    if rec.kind != "train" or rec.timeline is None:
        return None
    return rec.roofline_share("k2")
