"""The port's raster primitives (data/raster.py over csrc/raster.cpp) against
OpenCV, which the JAX package's hard generator calls.

Each primitive is held byte-equal to its cv2 call over seeded random draws
on random images and colours: shapes inside the image, clipped at its
edges and far outside it, thickness-2 outlines, degenerate 1-px axes and
single-point rectangles. ``resize_cubic`` is held to ``cv2.resize``
(INTER_CUBIC) as cv2 comes (a build with Intel IPP, which it calls when
both source sides are at least 4 pixels) over random sizes up and
down, sources below 4 pixels included, and the generator's two sizes.
"""

import cv2
import numpy as np
import pytest

from snn_object_detectionddp_tpu_torch.data import raster

DRAWS = 240


def _case(rng):
    h, w = int(rng.randint(1, 72)), int(rng.randint(1, 72))
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    color = tuple(int(c) for c in rng.randint(0, 256, 3))
    margin = int(rng.choice([0, 2, 12, 40]))
    lo, hi = -margin, max(h, w) + margin
    return img, color, lo, hi


def _point(rng, lo, hi):
    return tuple(int(v) for v in rng.randint(lo, hi, 2))


def _axes(rng, h, w):
    kind = rng.randint(4)
    if kind == 0:  # degenerate: a 0- or 1-px axis
        return int(rng.randint(0, 2)), int(rng.randint(0, max(h, w)))
    top = [3, 12, max(h, w), 80][kind]
    return int(rng.randint(0, top)), int(rng.randint(0, top))


def _draw(name, rng):
    img, color, lo, hi = _case(rng)
    a, b = img.copy(), img.copy()
    h, w = img.shape[:2]
    if name.startswith("rectangle"):
        thick = {"rectangle_1": 1, "rectangle_2": 2, "rectangle_fill": -1}[name]
        p1 = _point(rng, lo, hi)
        p2 = p1 if rng.rand() < 0.1 else _point(rng, lo, hi)
        cv2.rectangle(a, p1, p2, color, thick)
        raster.rectangle(b, p1, p2, color, thick)
    elif name.startswith("ellipse"):
        thick = {"ellipse_2": 2, "ellipse_fill": -1}[name]
        c, ax = _point(rng, lo, hi), _axes(rng, h, w)
        cv2.ellipse(a, c, ax, 0, 0, 360, color, thick)
        raster.ellipse(b, c, ax, color, thick)
    elif name == "fill_poly":
        pts = rng.randint(lo, hi, (3, 2)).astype(np.int32)
        cv2.fillPoly(a, [pts], color)
        raster.fill_poly(b, pts, color)
    else:
        closed = name == "polylines_closed_2"
        pts = rng.randint(lo, hi, (3, 2)).astype(np.int32)
        cv2.polylines(a, [pts], closed, color, 2)
        raster.polylines(b, pts, closed, color, 2)
    return a, b


@pytest.mark.parametrize("name", ["rectangle_1", "rectangle_2", "rectangle_fill", "ellipse_2",
                                  "ellipse_fill", "fill_poly", "polylines_closed_2",
                                  "polylines_open_2"])
def test_primitive_matches_cv2(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    bad = [i for i in range(DRAWS) if not np.array_equal(*_draw(name, rng))]
    assert not bad, f"{name}: {len(bad)} of {DRAWS} draws differ from cv2 (first {bad[:5]})"


def test_generator_shapes_clipped_at_the_edges():
    """The generator's own calls at the image border: thick outlines whose
    quads and caps leave the image, fills on the last row and column."""
    rng = np.random.RandomState(7)
    for _ in range(120):
        h, w = int(rng.randint(8, 60)), int(rng.randint(8, 60))
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        x1, y1 = int(rng.choice([0, 1, w // 2])), int(rng.choice([0, 1, h // 2]))
        x2, y2 = int(rng.choice([w - 1, w - 2, x1 + 1])), int(rng.choice([h - 1, h - 2, y1 + 1]))
        tri = np.array([[(x1 + x2) // 2, y1], [x1, y2], [x2, y2]], np.int32)
        axes = (max(1, (x2 - x1) // 2), max(1, (y2 - y1) // 2))
        centre = ((x1 + x2) // 2, (y1 + y2) // 2)
        for draw_cv, draw_port in (
            (lambda m: cv2.rectangle(m, (x1, y1), (x2, y2), color, 2),
             lambda m: raster.rectangle(m, (x1, y1), (x2, y2), color, 2)),
            (lambda m: cv2.ellipse(m, centre, axes, 0, 0, 360, color, 2),
             lambda m: raster.ellipse(m, centre, axes, color, 2)),
            (lambda m: cv2.ellipse(m, centre, axes, 0, 0, 360, color, -1),
             lambda m: raster.ellipse(m, centre, axes, color, -1)),
            (lambda m: cv2.polylines(m, [tri], True, color, 2),
             lambda m: raster.polylines(m, tri, True, color, 2)),
            (lambda m: cv2.fillPoly(m, [tri], color), lambda m: raster.fill_poly(m, tri, color)),
        ):
            a, b = img.copy(), img.copy()
            draw_cv(a)
            draw_port(b)
            assert np.array_equal(a, b)


@pytest.mark.parametrize("small_source", [False, True])
def test_resize_cubic_matches_cv2(small_source):
    rng = np.random.RandomState(int(small_source))
    for _ in range(80):
        lo, hi = (1, 4) if small_source else (4, 45)
        sh, sw = int(rng.randint(lo, hi)), int(rng.randint(1 if small_source else 4, 45))
        dh, dw = int(rng.randint(1, 260)), int(rng.randint(1, 260))
        src = rng.randint(0, 256, (sh, sw, 3)).astype(np.uint8)
        want = cv2.resize(src, (dw, dh), interpolation=cv2.INTER_CUBIC)
        assert np.array_equal(raster.resize_cubic(src, (dh, dw)), want), (sh, sw, dh, dw)


@pytest.mark.parametrize("hw", [(128, 160), (480, 640)])
def test_resize_cubic_at_the_generator_sizes(hw):
    rng = np.random.RandomState(hw[0])
    for _ in range(3):
        low = rng.randint(20, 120, size=(hw[0] // 16 + 1, hw[1] // 16 + 1, 3)).astype(np.uint8)
        want = cv2.resize(low, (hw[1], hw[0]), interpolation=cv2.INTER_CUBIC)
        assert np.array_equal(raster.resize_cubic(low, hw), want)


def test_bad_arguments_raise():
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ValueError, match="uint8 image"):
        raster.rectangle(img.astype(np.float32), (0, 0), (1, 1), (1, 2, 3), 1)
    with pytest.raises(ValueError, match="colour"):
        raster.rectangle(img, (0, 0), (1, 1), (1, 2, 300), 1)
    with pytest.raises(ValueError, match="refused"):
        raster.ellipse(img, (1, 1), (-1, 2), (1, 2, 3), 1)
    with pytest.raises(ValueError, match="points"):
        raster.fill_poly(img, np.zeros((0, 2)), (1, 2, 3))
    with pytest.raises(ValueError, match="uint8 image"):
        raster.resize_cubic(np.zeros((2, 2, 4), np.uint8), (4, 4))
