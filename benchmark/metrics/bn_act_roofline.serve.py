"""Share of its roofline (`benchmark/rooflines/bn_act.py`) that the port's eval
batch norm kernel `bn_act` (and its activation) reaches in the trace, in %."""


def read(rec):
    if rec.kind != "serve" or rec.timeline is None:
        return None
    return rec.roofline_share("bn_act")
