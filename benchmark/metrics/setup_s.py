"""Seconds from the process start to the first timed batch or step: imports,
the kernel build or load, weights, traffic, calibration, warm-up."""


def read(rec):
    return rec.setup_s
