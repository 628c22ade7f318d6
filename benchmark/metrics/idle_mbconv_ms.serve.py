"""Device idle ms a batch while the host was in `effv2.mbconv`, outside its
`effv2.se` gates (`harness/program_spans.py`). None where the system records
no such span."""
from harness import program_spans


def read(rec):
    if rec.kind != "serve":
        return None
    s = program_spans.session(rec)
    if s is None or "effv2.mbconv" not in s.names():
        return None
    return s.idle_ms("effv2.mbconv")
