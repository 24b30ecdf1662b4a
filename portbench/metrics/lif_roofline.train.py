"""A2 + A3 (the normalize+LIF forward with residual and its backward):
the least time their bytes take at the HBM peak, over their device time
in the traced sub-window, both per step."""

import json
from pathlib import Path

from portbench.counts import lif_train_bytes

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "peaks.json").read_text())


def read(rec):
    tr = rec.trace
    if rec.kind != "train" or tr is None:
        return None
    dev_s = tr.seconds_of("affine_lif_fwd_kernel") + tr.seconds_of("affine_lif_bwd_kernel")
    if dev_s <= 0:
        return None
    steps = rec.cell.traffic["profile_steps"]
    c = rec.counters
    least = steps * lif_train_bytes(rec.cell.shape, c["seq_len"], c["batch"]) / PEAKS["hbm_bytes_per_s"]
    return 100.0 * least / dev_s
