"""Share of its roofline (`benchmark/rooflines/qk1.py`) that the int8 convolution (QK1)
reaches in the trace, in %."""


def read(rec):
    if rec.kind != "serve" or rec.timeline is None:
        return None
    return rec.roofline_share("qk1")
