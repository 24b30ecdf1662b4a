"""``cv2.resize`` (INTER_LINEAR) on uint8 images and float32 fields, in numpy.

The HTTP endpoint resizes uploaded frames of another size to the served
one, and the tracker's flow path halves gray frames and scales flow fields
back up. OpenCV computes 8-bit bilinear in fixed point, and a float
bilinear misses it by 1 on some pixels, so this follows its arithmetic
step by step (``imgproc/src/resize.cpp``, the 8-bit linear path):

- source coordinate of a destination pixel: ``f = float((d + 0.5) * scale
  - 0.5)`` with ``scale = 1 / (dst / src)`` in double, ``s = floor(f)``,
  ``f -= s`` in float;
- columns clamp at the borders (``s < 0`` -> ``s = 0, f = 0``; ``s >=
  src - 1`` -> ``s = src - 1, f = 0``); rows keep their weights and clamp
  the row index;
- weights in 11 fractional bits: ``rint((1 - f) * 2048)``, ``rint(f *
  2048)`` (round half to even);
- horizontal pass in int32: ``S = p[s] * a0 + p[s + 1] * a1``;
- vertical pass as OpenCV's vector code does it: ``((S0 >> 4) * b0 >> 16)
  + ((S1 >> 4) * b1 >> 16)``, then ``(v + 2) >> 2``, saturated to uint8.

Byte-equal to ``cv2.resize`` over random sizes, up and down
(tests/test_torch_resize.py). An exact halving, which OpenCV runs as
INTER_AREA, gives the same bytes through these formulas.

float32 (:func:`resize_linear_f32`) takes the same coordinates with float
weights ``1 - f, f`` and no fixed point; there OpenCV's exact halving
(INTER_AREA) is ``(((a + b) + c) + d) * 0.25`` over each 2x2 block.
``cv2.resize(img, None, fx=s, fy=s)`` (:func:`rescale_u8`) takes its scale
from ``1 / s`` rather than from the two sizes, and the halving averages
the pixels a 2x2 block has at an odd border (tests/test_torch_flow.py).
"""

from __future__ import annotations

import numpy as np

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS


def _taps(src: int, dst: int, scale: float | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(first source index, float32 fraction) for each destination index;
    ``scale`` (source pixels per destination pixel) defaults to the sizes'."""
    if scale is None:
        scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    return s.astype(np.int64), (f - s).astype(np.float32)


def _weights(f: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    one = np.float32(1.0)
    scale = np.float32(COEF_SCALE)
    return (np.rint((one - f) * scale).astype(np.int64),
            np.rint(f * scale).astype(np.int64))


def _check_size(hw) -> tuple[int, int]:
    h, w = (int(v) for v in hw)
    if h < 1 or w < 1:
        raise ValueError(f"target size {hw} must be positive")
    return h, w


def _column_taps(src_w: int, w: int, scale: float | None) -> tuple[np.ndarray, np.ndarray]:
    """Columns clamp at both borders with a zero fraction."""
    sx, fx = _taps(src_w, w, scale)
    left = sx < 0
    sx[left], fx[left] = 0, 0
    right = sx >= src_w - 1
    sx[right], fx[right] = src_w - 1, 0
    return sx, fx


def _linear_u8(img: np.ndarray, h: int, w: int, sx_scale=None, sy_scale=None) -> np.ndarray:
    src_h, src_w = img.shape[:2]
    x = img.astype(np.int32) if img.ndim == 3 else img.astype(np.int32)[..., None]
    sx, fx = _column_taps(src_w, w, sx_scale)
    a0, a1 = _weights(fx)
    rows = x[:, sx] * a0[None, :, None] + x[:, np.minimum(sx + 1, src_w - 1)] * a1[None, :, None]

    sy, fy = _taps(src_h, h, sy_scale)
    b0, b1 = _weights(fy)
    s0 = rows[np.clip(sy, 0, src_h - 1)] >> 4
    s1 = rows[np.clip(sy + 1, 0, src_h - 1)] >> 4
    v = ((s0 * b0[:, None, None]) >> 16) + ((s1 * b1[:, None, None]) >> 16)
    out = np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)
    return out if img.ndim == 3 else out[..., 0]


def _check_u8(name: str, img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or 0 in img.shape:
        raise ValueError(f"{name} takes an (H, W[, C]) uint8 image, got {img.dtype} {img.shape}")
    return img


def resize_linear_u8(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Resize an (H, W) or (H, W, C) uint8 image to ``hw`` = (h, w) with
    OpenCV's INTER_LINEAR arithmetic. Returns a new uint8 array."""
    img = _check_u8("resize_linear_u8", img)
    h, w = _check_size(hw)
    if (h, w) == img.shape[:2]:
        return img.copy()
    return _linear_u8(img, h, w)


def _halve_u8(img: np.ndarray) -> np.ndarray:
    """OpenCV's INTER_AREA halving: ``(a + b + c + d + 2) >> 2`` over each
    full 2x2 block; a block cut by an odd border averages the pixels it
    has, ``rint(float(sum) / count)``."""
    src_h, src_w = img.shape[:2]
    h, w = round(src_h * 0.5), round(src_w * 0.5)  # cvRound: half to even
    x = img.astype(np.int32) if img.ndim == 3 else img.astype(np.int32)[..., None]
    pad = np.zeros((2 * h, 2 * w, x.shape[2]), np.int32)
    cnt = np.zeros((2 * h, 2 * w, 1), np.int32)
    hh, ww = min(2 * h, src_h), min(2 * w, src_w)
    pad[:hh, :ww], cnt[:hh, :ww] = x[:hh, :ww], 1
    blocks = lambda a: a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2]  # noqa: E731
    total, count = blocks(pad), blocks(cnt)
    partial = np.rint(total.astype(np.float32) / np.maximum(count, 1).astype(np.float32))
    out = np.where(count == 4, (total + 2) >> 2, partial.astype(np.int32))
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out if img.ndim == 3 else out[..., 0]


def rescale_u8(img: np.ndarray, factor: float) -> np.ndarray:
    """``cv2.resize(img, None, fx=factor, fy=factor)`` (INTER_LINEAR) of an
    (H, W) or (H, W, C) uint8 image: the size is ``rint(side * factor)``
    and the scale ``1 / factor``; a factor of exactly 0.5 is OpenCV's area
    halving. Returns a new uint8 array."""
    img = _check_u8("rescale_u8", img)
    if not factor > 0:
        raise ValueError(f"scale factor {factor} must be positive")
    scale = 1.0 / factor
    if scale == 2.0:
        return _halve_u8(img)
    h, w = _check_size((round(img.shape[0] * factor), round(img.shape[1] * factor)))
    return _linear_u8(img, h, w, scale, scale)


def resize_linear_f32(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` (INTER_LINEAR) of an (H, W) or (H, W, C)
    float32 array, such as a flow field: OpenCV's coordinates with float
    weights, its exact halving as INTER_AREA. Returns a new float32 array."""
    img = np.asarray(img)
    if img.dtype != np.float32 or img.ndim not in (2, 3) or 0 in img.shape:
        raise ValueError(f"resize_linear_f32 takes an (H, W[, C]) float32 array, got {img.dtype} "
                         f"{img.shape}")
    h, w = _check_size(hw)
    src_h, src_w = img.shape[:2]
    if (h, w) == (src_h, src_w):
        return img.copy()
    x = img if img.ndim == 3 else img[..., None]
    if 2 * h == src_h and 2 * w == src_w:
        out = (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]) * np.float32(0.25)
        return out if img.ndim == 3 else out[..., 0]
    one = np.float32(1.0)
    sx, fx = _column_taps(src_w, w, None)
    rows = (x[:, sx] * (one - fx)[None, :, None]
            + x[:, np.minimum(sx + 1, src_w - 1)] * fx[None, :, None])
    sy, fy = _taps(src_h, h)
    out = (rows[np.clip(sy, 0, src_h - 1)] * (one - fy)[:, None, None]
           + rows[np.clip(sy + 1, 0, src_h - 1)] * fy[:, None, None])
    return out if img.ndim == 3 else out[..., 0]
