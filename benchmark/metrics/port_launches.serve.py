"""Launches of the port's own kernels a batch, from the system's launch
stamps."""
from harness import program_spans


def read(rec):
    if rec.kind != "serve":
        return None
    s = program_spans.session(rec)
    return None if s is None else s.launches_per_iteration()
