"""Serving: the 95th percentile, over every batch of the window, of the time
from a batch's submission to its outputs on the host."""
import numpy as np


def read(rec):
    return float(np.percentile(rec.latency_ms, 95)) if rec.kind == "serve" else None
