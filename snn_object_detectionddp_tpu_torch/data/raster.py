"""OpenCV's raster primitives without OpenCV: a ctypes bridge to ``csrc/raster.cpp``.

The JAX package's "hard" synthetic generator draws with ``cv2.resize``
(INTER_CUBIC), ``cv2.rectangle``, ``cv2.ellipse``, ``cv2.fillPoly`` and
``cv2.polylines``. These functions reproduce those calls byte for byte on
3-channel uint8 images, at LINE_8 and shift 0, as the generator makes them
(tests/test_torch_raster.py holds each to cv2 over seeded random draws,
clipped at the image edges included). Drawing is in place; a colour is
three ints in the image's own channel order.

``resize_cubic`` takes 3-channel images and gives what this repository's
reference cv2 (OpenCV 5.0.0 with Intel IPP, on x86-64) gives by default:
IPP's INTER_CUBIC arithmetic when both source sides are at least 4 pixels,
OpenCV's own below that (csrc/raster.cpp spells out both).

The library is built at first use by ``kernels/build.py`` with the host C++
compiler; a failed build raises. There is no numpy fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..kernels import build

SOURCE = "raster.cpp"
_P, _I = ctypes.c_void_p, ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    for name, args in (
        ("snn_raster_rectangle", [_P, _I, _I, _I, _I, _I, _I, _P, _I]),
        ("snn_raster_ellipse", [_P, _I, _I, _I, _I, _I, _I, _P, _I]),
        ("snn_raster_fill_poly", [_P, _I, _I, _P, _I, _P]),
        ("snn_raster_polylines", [_P, _I, _I, _P, _I, _I, _P, _I]),
        ("snn_raster_resize_cubic", [_P, _I, _I, _P, _I, _I]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, args


def _lib() -> ctypes.CDLL:
    return build.load(SOURCE, _declare)


def _canvas(img: np.ndarray) -> np.ndarray:
    if (img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3 or not img.flags.c_contiguous
            or not img.flags.writeable or 0 in img.shape):
        raise ValueError(f"drawing takes a writable C-contiguous (H, W, 3) uint8 image, got "
                         f"{img.dtype} {img.shape}")
    return img


def _color(color) -> np.ndarray:
    c = np.asarray([int(v) for v in color], np.int64)
    if c.shape != (3,) or (c < 0).any() or (c > 255).any():
        raise ValueError(f"colour must be three values in 0..255, got {color}")
    return c.astype(np.uint8)


def _points(pts) -> np.ndarray:
    p = np.ascontiguousarray(np.asarray(pts, np.int64).reshape(-1, 2))
    if len(p) == 0 or (np.abs(p) >= 1 << 24).any():
        raise ValueError(f"need 1 or more (x, y) points with |coordinate| < 2**24, got {len(p)}")
    return p.astype(np.int32)


def _call(name: str, *args) -> None:
    if getattr(_lib(), name)(*args) != 0:
        raise ValueError(f"{name} refused its arguments")


def rectangle(img: np.ndarray, pt1, pt2, color, thickness: int) -> None:
    """``cv2.rectangle(img, pt1, pt2, color, thickness)``; -1 fills."""
    img, c = _canvas(img), _color(color)
    _call("snn_raster_rectangle", img.ctypes.data, img.shape[0], img.shape[1],
          int(pt1[0]), int(pt1[1]), int(pt2[0]), int(pt2[1]), c.ctypes.data, int(thickness))


def ellipse(img: np.ndarray, center, axes, color, thickness: int) -> None:
    """``cv2.ellipse(img, center, axes, 0, 0, 360, color, thickness)``: the
    full ellipse at angle 0; -1 fills."""
    img, c = _canvas(img), _color(color)
    _call("snn_raster_ellipse", img.ctypes.data, img.shape[0], img.shape[1],
          int(center[0]), int(center[1]), int(axes[0]), int(axes[1]), c.ctypes.data, int(thickness))


def fill_poly(img: np.ndarray, pts, color) -> None:
    """``cv2.fillPoly(img, [pts], color)`` of one contour of (x, y) points."""
    img, c, p = _canvas(img), _color(color), _points(pts)
    _call("snn_raster_fill_poly", img.ctypes.data, img.shape[0], img.shape[1], p.ctypes.data,
          len(p), c.ctypes.data)


def polylines(img: np.ndarray, pts, closed: bool, color, thickness: int) -> None:
    """``cv2.polylines(img, [pts], closed, color, thickness)`` of one contour."""
    img, c, p = _canvas(img), _color(color), _points(pts)
    _call("snn_raster_polylines", img.ctypes.data, img.shape[0], img.shape[1], p.ctypes.data,
          len(p), int(bool(closed)), c.ctypes.data, int(thickness))


def resize_cubic(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)`` of an
    (H, W, 3) uint8 image (see the module docstring). Returns a new array."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3 or 0 in img.shape:
        raise ValueError(f"resize_cubic takes an (H, W, 3) uint8 image, got {img.dtype} {img.shape}")
    h, w = (int(v) for v in hw)
    if h < 1 or w < 1:
        raise ValueError(f"target size {hw} must be positive")
    if (h, w) == img.shape[:2]:
        return img.copy()
    out = np.empty((h, w, 3), np.uint8)
    _call("snn_raster_resize_cubic", img.ctypes.data, img.shape[0], img.shape[1], out.ctypes.data, h, w)
    return out
