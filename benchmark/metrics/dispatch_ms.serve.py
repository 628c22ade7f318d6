"""Host ms a batch from calling predict_* to its return, over the window's
batches."""
import numpy as np


def read(rec):
    if rec.kind != "serve" or rec.timeline is None:
        return None
    return float(np.mean(rec.host_ms))
