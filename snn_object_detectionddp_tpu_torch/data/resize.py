"""``cv2.resize(img, (w, h))`` (INTER_LINEAR) on uint8 images, in numpy.

The HTTP endpoint resizes uploaded frames of another size to the served
one. OpenCV computes 8-bit bilinear in fixed point, and a float bilinear
misses it by 1 on some pixels, so this follows its arithmetic step by step
(``imgproc/src/resize.cpp``, the 8-bit linear path):

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
"""

from __future__ import annotations

import numpy as np

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS


def _taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """(first source index, float32 fraction) for each destination index."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    return s.astype(np.int64), (f - s).astype(np.float32)


def _weights(f: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    one = np.float32(1.0)
    scale = np.float32(COEF_SCALE)
    return (np.rint((one - f) * scale).astype(np.int64),
            np.rint(f * scale).astype(np.int64))


def resize_linear_u8(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Resize an (H, W) or (H, W, C) uint8 image to ``hw`` = (h, w) with
    OpenCV's INTER_LINEAR arithmetic. Returns a new uint8 array."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or 0 in img.shape:
        raise ValueError(f"resize_linear_u8 takes an (H, W[, C]) uint8 image, got {img.dtype} "
                         f"{img.shape}")
    h, w = (int(v) for v in hw)
    if h < 1 or w < 1:
        raise ValueError(f"target size {hw} must be positive")
    src_h, src_w = img.shape[:2]
    if (h, w) == (src_h, src_w):
        return img.copy()
    x = img.astype(np.int32) if img.ndim == 3 else img.astype(np.int32)[..., None]

    sx, fx = _taps(src_w, w)
    left = sx < 0
    sx[left], fx[left] = 0, 0
    right = sx >= src_w - 1
    sx[right], fx[right] = src_w - 1, 0
    a0, a1 = _weights(fx)
    rows = x[:, sx] * a0[None, :, None] + x[:, np.minimum(sx + 1, src_w - 1)] * a1[None, :, None]

    sy, fy = _taps(src_h, h)
    b0, b1 = _weights(fy)
    s0 = rows[np.clip(sy, 0, src_h - 1)] >> 4
    s1 = rows[np.clip(sy + 1, 0, src_h - 1)] >> 4
    v = ((s0 * b0[:, None, None]) >> 16) + ((s1 * b1[:, None, None]) >> 16)
    out = np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)
    return out if img.ndim == 3 else out[..., 0]
