"""Host ms a batch in the system's `serve.forward` span: the enqueue of the
normalise or warp, the backbone, the decode, TTA and the reconstruction."""
from harness import program_spans


def read(rec):
    if rec.kind != "serve":
        return None
    s = program_spans.session(rec)
    return None if s is None else s.host_ms("serve.forward")
