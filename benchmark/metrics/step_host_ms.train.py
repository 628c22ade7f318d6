"""Host ms to enqueue one train step, over the window's steps."""
import numpy as np


def read(rec):
    if rec.kind != "train" or rec.timeline is None:
        return None
    return float(np.mean(rec.host_ms))
