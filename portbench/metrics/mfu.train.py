"""The train step's share of the card's bf16 dense peak: FLOPs of forward
and backward at the cell's shapes (convs and matrix products, counted by
the benchmark over its frozen reference; the LIF and elementwise work
count nothing) x steps, over the traced run's wall time outside the
profiler's sub-window."""

import json
from pathlib import Path

from portbench.counts import model_flops, shape_key

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "peaks.json").read_text())


def read(rec):
    c = rec.counters
    if rec.kind != "train" or rec.device.type != "cuda" or c.get("untraced_s", 0) <= 0:
        return None
    flops = model_flops(shape_key(rec.cell.shape), c["seq_len"], c["batch"], True)
    return 100.0 * flops * c["untraced_steps"] / c["untraced_s"] / PEAKS["bf16_dense_flops_per_s"]
