"""Device idle ms a batch while the host was in no span of the system: the
harness's `fetch` and `collect` (`harness/program_spans.py`)."""
from harness import program_spans


def read(rec):
    if rec.kind != "serve":
        return None
    s = program_spans.session(rec)
    return None if s is None else s.idle_ms(program_spans.CLIENT)
