"""Bytes a batch of the EfficientNetV2 blocks' expand and depthwise conv
outputs, in MB (10^6 bytes), from the system's counter
`effv2.expanded_bytes`. None where the system counts no such bytes."""
from harness import program_spans

COUNTER = "effv2.expanded_bytes"


def read(rec):
    if rec.kind != "serve":
        return None
    s = program_spans.session(rec)
    if s is None or not any(c["name"] == COUNTER for c in s.counts):
        return None
    return s.count(COUNTER) / 1e6
