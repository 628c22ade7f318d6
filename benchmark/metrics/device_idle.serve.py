"""Share of the traced window with nothing running on the device, in %."""


def read(rec):
    if rec.kind != "serve" or rec.timeline is None:
        return None
    return 100.0 * (1.0 - rec.timeline.busy_s / rec.timeline.window_s)
