"""Device idle ms a batch while the host was in `serve.to_device`
(`harness/program_spans.py`)."""
from harness import program_spans


def read(rec):
    if rec.kind != "serve":
        return None
    s = program_spans.session(rec)
    return None if s is None else s.idle_ms("serve.to_device")
