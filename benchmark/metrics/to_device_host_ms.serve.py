"""Host ms a batch in the system's `serve.to_device` span: the pageable
copies of the batch to the card and the stream sync they make."""
from harness import program_spans


def read(rec):
    if rec.kind != "serve":
        return None
    s = program_spans.session(rec)
    return None if s is None else s.host_ms("serve.to_device")
