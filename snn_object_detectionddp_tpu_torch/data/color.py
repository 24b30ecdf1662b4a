"""``cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)`` on uint8 and
``cv2.GaussianBlur(img, (0, 0), sigma)`` on float32, in numpy.

The tracker's learned-flow path turns frames to gray and blurs the noise
of its synthetic training pairs with these two OpenCV calls; the port
computes them without OpenCV:

- gray: OpenCV 5's fixed point in 15 bits, ``(B * 3735 + G * 19235 + R *
  9798 + 16384) >> 15`` (OpenCV 4's 14-bit ``1868 / 9617 / 4899`` misses
  it by 1 on some pixels);
- blur: OpenCV's kernel size for float data, ``rint(sigma * 8 + 1) | 1``,
  its Gaussian taps computed in double and rounded to float32, borders
  ``BORDER_REFLECT_101``, and its float32 arithmetic as its vector code
  runs it: the row pass a chain over the taps in order, the column pass
  the centre tap's product, then each tap pair ``k[i] * (x[c - i] + x[c +
  i])`` outwards (the symmetric column filter). The row pass fuses each
  multiply-add in the columns its 8- and 4-lane loops cover (all but the
  last ``W % 4``), the column pass in its 8-lane loop (all but the last
  ``W % 8``); the remaining columns round each product, then each sum
  (OpenCV's scalar loops). A fused multiply-add is computed in double and
  rounded to float32: the product of two floats is exact in double, so
  only a sum that lands halfway between two floats could round otherwise.

Both are held against cv2 in tests/test_torch_flow.py.
"""

from __future__ import annotations

import numpy as np

GRAY_SHIFT = 15
GRAY_BGR = (3735, 19235, 9798)


def bgr_to_gray_u8(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR -> (H, W) uint8 gray, OpenCV's arithmetic."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"bgr_to_gray_u8 takes an (H, W, 3) uint8 image, got {img.dtype} {img.shape}")
    x = img.astype(np.int32)
    cb, cg, cr = GRAY_BGR
    y = x[..., 0] * cb + x[..., 1] * cg + x[..., 2] * cr + (1 << (GRAY_SHIFT - 1))
    return (y >> GRAY_SHIFT).astype(np.uint8)


def gaussian_taps(sigma: float) -> np.ndarray:
    """OpenCV's float32 Gaussian kernel for float images (``getGaussianKernel``
    at the size ``GaussianBlur`` picks for them)."""
    n = int(np.rint(sigma * 8 + 1)) | 1
    x = np.arange(n, dtype=np.float64) - (n - 1) * 0.5
    t = np.exp((-0.5 / (sigma * sigma)) * x * x)
    return (t * (1.0 / t.sum())).astype(np.float32)


def _fma(a, b, c) -> np.ndarray:
    return (np.float64(a) * b.astype(np.float64) + c).astype(np.float32)


def gaussian_blur_f32(img: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` of an (H, W) float32 image."""
    img = np.asarray(img)
    if img.dtype != np.float32 or img.ndim != 2 or not sigma > 0:
        raise ValueError(f"gaussian_blur_f32 takes an (H, W) float32 image and sigma > 0, got "
                         f"{img.dtype} {img.shape}, sigma {sigma}")
    k = gaussian_taps(sigma)
    r = len(k) // 2
    h, w = img.shape
    if r >= h or r >= w:
        raise ValueError(f"a {len(k)}-tap kernel needs an image of more than {r} pixels a side")
    p = np.pad(img, r, mode="reflect")  # numpy's reflect is REFLECT_101
    v4, v8 = w - w % 4, w - w % 8  # the columns of the 4- and 8-lane loops
    rows = np.zeros((h + 2 * r, w), np.float32)
    for i in range(len(k)):
        rows[:, :v4] = _fma(k[i], p[:, i:i + v4], rows[:, :v4])
    tail = k[0] * p[:, v4:w]
    for i in range(1, len(k)):
        tail = tail + k[i] * p[:, v4 + i:w + i]
    rows[:, v4:] = tail
    out = k[r] * rows[r:r + h]
    for i in range(1, r + 1):
        pair = rows[r - i:r - i + h] + rows[r + i:r + i + h]
        out[:, :v8] = _fma(k[r + i], pair[:, :v8], out[:, :v8])
        out[:, v8:] = out[:, v8:] + k[r + i] * pair[:, v8:]
    return out
