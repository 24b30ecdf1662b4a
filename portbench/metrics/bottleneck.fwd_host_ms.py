"""Mean host ms a train step inside the U-Net bottleneck module's
forward, from pre/post forward hooks the benchmark registers on it, over
the traced run's steps outside the profiler's sub-window."""

import numpy as np


def read(rec):
    spans = rec.spans.get("bottleneck_forward")
    return float(np.mean(spans)) * 1e3 if spans else None
