"""The allocator's peak over the window (reset at its start), in GiB."""


def read(rec):
    if rec.kind != "train" or rec.timeline is None:
        return None
    return rec.peak_window_bytes / 2**30
