"""Share of its roofline (`benchmark/rooflines/k3.py`) that the stem max pool (K3)
reaches in the trace, in %."""


def read(rec):
    if rec.kind != "serve" or rec.timeline is None:
        return None
    return rec.roofline_share("k3")
