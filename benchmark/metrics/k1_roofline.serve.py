"""Share of its roofline (`benchmark/rooflines/k1.py`) that the crop warp (K1)
reaches in the trace, in %."""


def read(rec):
    if rec.kind != "serve" or rec.timeline is None:
        return None
    return rec.roofline_share("k1")
