"""95th percentile of detect() latency over every request sent in the
window, submit to reply on the client's clock; a failed request counts
as missing every limit (infinite)."""

import math

import numpy as np


def read(rec):
    if rec.kind != "serve" or not rec.latencies_s:
        return None
    value = float(np.percentile(np.array(rec.latencies_s), 95, method="higher")) * 1e3
    return value if math.isfinite(value) else 1e12
