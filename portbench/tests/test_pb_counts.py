"""The benchmark's own counts, pinned to the figures the port's chip runs
and the earlier chip runs reckoned: A2 620 MB and A3 783 MB over the 20 spiking shapes
at T=5 B=2, A1 97.8 MB at B=1 T=1, and the forward FLOPs of a frame of
each configuration (counted on the meta device: no memory, no compute)."""

import numpy as np
import pytest

from portbench import counts
from portbench.reference.model import ModelShape, param_spec

FULL = ModelShape()
TOKEN = ModelShape(bottleneck="lstm")


def test_spiking_shapes_are_the_twenty_blocks():
    shapes = counts.spiking_shapes(FULL)
    assert len(shapes) == 20
    assert shapes[0] == (120, 160, 48) and shapes[-1] == (8, 10, 1024)


def test_lif_bytes_pinned():
    res = sum(counts.lif_bytes_res(2 * h * w * c, 5, c, 2) for h, w, c in counts.spiking_shapes(FULL))
    bwd = sum(counts.lif_bytes_bwd(2 * h * w * c, 5, c, 2) for h, w, c in counts.spiking_shapes(FULL))
    assert round(res / 1e6) == 620 and round(bwd / 1e6) == 783
    assert counts.lif_train_bytes(FULL, 5, 2) == res + bwd
    assert round(counts.lif_serve_bytes(FULL, 1) / 1e5) == 979  # 97.9 MB
    assert counts.lif_serve_bytes(FULL, 16) > 15 * counts.lif_serve_bytes(FULL, 1)


@pytest.mark.parametrize("shape, gflop, n_params", [(FULL, 62.1, 131_931_896),
                                                     (TOKEN, 52.8, 73_215_736)])
def test_flops_and_parameters_pinned(shape, gflop, n_params):
    fwd = counts.model_flops(counts.shape_key(shape), 1, 1, False)
    assert round(fwd / 1e9, 1) == gflop
    assert sum(int(np.prod(s)) for _, s, _, _ in param_spec(shape)) == n_params


def test_train_flops_scale_with_the_window():
    small = ModelShape(preset="yolo11n.pt", width_mult=0.25, image_size=(64, 96))
    one = counts.model_flops(counts.shape_key(small), 1, 1, True)
    assert counts.model_flops(counts.shape_key(small), 2, 3, True) > 3 * one
    assert one > 2 * counts.model_flops(counts.shape_key(small), 1, 1, False)
