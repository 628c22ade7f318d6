"""Host ms a batch in the system's `effv2.mbconv` span: the enqueue of the
MBConv stages (4 to 7 of EfficientNetV2-L), their squeeze-excitation gates
included. None where the system records no such span."""
from harness import program_spans


def read(rec):
    if rec.kind != "serve":
        return None
    s = program_spans.session(rec)
    if s is None or "effv2.mbconv" not in s.names():
        return None
    return s.host_ms("effv2.mbconv")
