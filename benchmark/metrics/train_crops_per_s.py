"""Training: rows trained over the whole window."""


def read(rec):
    return rec.items / rec.window_s if rec.kind == "train" else None
