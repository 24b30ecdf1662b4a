"""A1 (the normalize+LIF forward of the streaming step): the least time
the bytes of the frames it served take at the HBM peak, over its device
time in the traced sub-window. The dispatches in the sub-window are its A1
launches over the 20 spiking blocks; the frames a dispatch served follow
the replies received in the sub-window, each of which names its
dispatch's count of requests. A padded slot's work counts in the time and
not in the bytes."""

import json
from pathlib import Path

from portbench.counts import lif_serve_bytes, spiking_shapes

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "peaks.json").read_text())


def read(rec):
    tr = rec.trace
    sizes = rec.counters.get("dispatch_sizes") if rec.kind == "serve" else None
    if tr is None or not sizes:
        return None
    dev_s = tr.seconds_of("affine_lif_fwd_kernel")
    dispatches = tr.count_of("affine_lif_fwd_kernel") / len(spiking_shapes(rec.cell.shape))
    if dev_s <= 0 or dispatches <= 0:
        return None
    # a dispatch of n requests gives n replies that each say n
    frames_per_dispatch = len(sizes) / sum(1.0 / n for n in sizes)
    least = dispatches * frames_per_dispatch * lif_serve_bytes(rec.cell.shape, 1) \
        / PEAKS["hbm_bytes_per_s"]
    return 100.0 * least / dev_s
