"""Share of its roofline (`benchmark/rooflines/dwconv.py`) that the port's
depthwise conv kernel reaches in the trace, in %."""


def read(rec):
    if rec.kind != "serve" or rec.timeline is None:
        return None
    return rec.roofline_share("dwconv")
