"""Serving's share of the card's bf16 dense peak: the forward FLOPs of a
T=1 frame (counted by the benchmark over its frozen reference) x frames
replied, over the traced run's window outside the profiler's
sub-window."""

import json
from pathlib import Path

from portbench.counts import model_flops, shape_key

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "peaks.json").read_text())


def read(rec):
    c = rec.counters
    if rec.kind != "serve" or rec.device.type != "cuda" or c.get("untraced_s", 0) <= 0:
        return None
    flops = model_flops(shape_key(rec.cell.shape), 1, 1, False)
    return 100.0 * flops * c["untraced_frames"] / c["untraced_s"] / PEAKS["bf16_dense_flops_per_s"]
