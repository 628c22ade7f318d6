"""Share of its roofline (`benchmark/rooflines/qk2.py`) that the int8 quantize (QK2)
reaches in the trace, in %."""


def read(rec):
    if rec.kind != "serve" or rec.timeline is None:
        return None
    return rec.roofline_share("qk2")
