"""Serving: crops whose outputs reached the host, over the whole window."""


def read(rec):
    return rec.items / rec.window_s if rec.kind == "serve" else None
