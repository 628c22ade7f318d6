"""Host ms a batch in the system's `int8.weights` span: the per-call
quantization of the convolutions' weights."""
from harness import program_spans


def read(rec):
    if rec.kind != "serve":
        return None
    s = program_spans.session(rec)
    return None if s is None else s.host_ms("int8.weights")
