"""Device idle ms a step while the host was in `train.backward`
(`harness/program_spans.py`)."""
from harness import program_spans


def read(rec):
    if rec.kind != "train":
        return None
    s = program_spans.session(rec)
    return None if s is None else s.idle_ms("train.backward")
