"""int8 weight bytes a batch that `QuantConv.int8_weights` writes anew, in MB
(10^6 bytes), from the system's counter `int8.weight_bytes`."""
from harness import program_spans


def read(rec):
    if rec.kind != "serve":
        return None
    s = program_spans.session(rec)
    return None if s is None else s.count("int8.weight_bytes") / 1e6
