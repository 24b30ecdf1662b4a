"""Mean host ms from the call into train_step to its return (no sync),
over the traced run's steps outside the profiler's sub-window."""

import numpy as np


def read(rec):
    steps = rec.spans.get("train_step")
    return float(np.mean(steps)) * 1e3 if steps else None
