"""Dense optical flow by Gunnar Farneback's polynomial expansion, as
``cv2.calcOpticalFlowFarneback(prev, next, None, 0.5, 3, 15, 3, 5, 1.2, 0)``
computes it, in PyTorch on an explicit device.

The tracker benchmark (evals/legacy.py) moves its boxes by this flow
between detector frames. One plain function a stage, each on float32
tensors of one device, following OpenCV's ``modules/video/src/optflowgf.cpp``:

- :func:`level_geometry`: the pyramid. Levels shrink by ``pyr_scale``
  while both sides times the scale stay at least 32 pixels; a level's
  size is ``round(side * scale)`` (half to even);
- :func:`level_image`: each level's image is the full-resolution frame,
  blurred with a Gaussian of ``sigma = (1 / scale - 1) / 2`` and size
  ``round(sigma * 5) | 1`` (at least 3; at the finest level sigma is 0
  and OpenCV's fixed 3-tap kernel ``[1, 2, 1] / 4`` blurs it),
  ``BORDER_REFLECT_101``, then resized to the level's size
  (``INTER_LINEAR``, an exact halving as OpenCV's 2x2 area mean);
- :func:`poly_exp`: the polynomial expansion of both level images, the
  weighted least-squares fit of a quadratic in each ``2 poly_n + 1``
  window under a Gaussian applicability of ``poly_sigma``, borders
  replicated (OpenCV's separable passes and the inverse moments of the
  applicability folded into five 2D kernels); five coefficient fields
  ``(r_y, r_x, r_yy, r_xx, r_xy)``;
- :func:`update_matrices`: the second frame's coefficients sampled
  bilinearly at each pixel plus its flow (a sample that needs a pixel
  outside the image falls back to the first frame's quadratic terms and a
  zero linear term), averaged with the first frame's, damped on the
  5-pixel band at the border; five fields ``(G11, G12, G22, h1, h2)``;
- :func:`update_flow`: a ``winsize`` box mean of the five fields with
  replicated borders, in float64, and the 2x2 solve with ``1e-3`` added to
  the determinant. OpenCV refreshes the matrices from the new flow in row
  stripes behind the box filter, whose window never reaches a refreshed
  row, so refreshing them after each pass is the same computation;
- :func:`calc_flow`: coarse to fine; the coarsest level starts from zero
  flow, each finer one from the coarser flow resized to its size and
  multiplied by ``1 / pyr_scale``; ``iterations`` flow updates a level.

The per-pixel float32 operations of the matrix update, the resizes and
the solve run in OpenCV's order. The blur and the polynomial expansion are
2D correlations in float64 rounded once to float32, and the box filter
runs in float64 as OpenCV's does: these differ from OpenCV's vector code
by rounding. Where frames leave the normal equations nearly singular (a
bright block over dim noise), the iterations can amplify such rounding
well past it, whatever the summation order.
``evals/flow.py::farneback_flow`` is the entry point.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..data.resize import _column_taps, _taps

PYR_SCALE = 0.5
LEVELS = 3
WINSIZE = 15
ITERATIONS = 3
POLY_N = 5
POLY_SIGMA = 1.2
MIN_SIZE = 32  # a level's shorter side, times its scale, stays at least this
BORDER = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], np.float32)
# OpenCV's fixed kernel of a 3-tap blur at sigma 0 (the finest level's)
GAUSSIAN_3 = (0.25, 0.5, 0.25)


def level_geometry(h: int, w: int, levels: int = LEVELS) -> list[tuple[float, int, int]]:
    """(scale, height, width) of each pyramid level, coarsest first."""
    scale, k = 1.0, 0
    while k < levels:
        scale *= PYR_SCALE
        if w * scale < MIN_SIZE or h * scale < MIN_SIZE:
            break
        k += 1
    out = []
    for lvl in range(k, -1, -1):
        s = 1.0
        for _ in range(lvl):
            s *= PYR_SCALE
        out.append((s, round(h * s), round(w * s)))
    return out


def blur_params(scale: float) -> tuple[int, float]:
    """(kernel size, sigma) of the Gaussian that smooths a level at ``scale``."""
    sigma = (1.0 / scale - 1.0) * 0.5
    return max(round(sigma * 5) | 1, 3), sigma


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV's float32 Gaussian taps (``getGaussianKernel``):
    ``exp(-x^2 / (2 sigma^2))`` in float64, normalised, rounded to float32;
    at sigma 0, which :func:`blur_params` gives only with 3 taps, OpenCV's
    fixed ``[1, 2, 1] / 4``."""
    if sigma <= 0:
        return np.array(GAUSSIAN_3, np.float32)
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    t = np.exp((-0.5 / (sigma * sigma)) * x * x)
    return (t * (1.0 / t.sum())).astype(np.float32)


# The constants below are copied to the device once (functools.lru_cache): a
# copy from pageable host memory inside a call would wait for the device's
# queued work every time.
@functools.lru_cache(maxsize=16)
def _blur_weight(ksize: int, sigma: float, device: str) -> torch.Tensor:
    k = gaussian_kernel(ksize, sigma).astype(np.float64)
    return torch.as_tensor(np.outer(k, k)[None, None], device=device)


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """``cv2.GaussianBlur(img, (ksize, ksize), sigma, sigma)`` of (..., H, W)
    float32 images, ``BORDER_REFLECT_101``: one 2D correlation in float64
    with the outer product of OpenCV's float32 taps (exact in float64),
    rounded to float32 once (OpenCV rounds after each of its two passes)."""
    r = ksize // 2
    h, w = img.shape[-2:]
    if r >= h or r >= w:
        raise ValueError(f"a {ksize}-tap blur needs an image of more than {r} pixels a side")
    x = F.pad(img.reshape(-1, 1, h, w).double(), (r, r, r, r), mode="reflect")
    return F.conv2d(x, _blur_weight(ksize, sigma, str(img.device))).float().reshape(img.shape)


@functools.lru_cache(maxsize=64)
def _linear_taps(src_h: int, src_w: int, h: int, w: int, device: str):
    sx, fx = _column_taps(src_w, w, None)
    sy, fy = _taps(src_h, h)
    one = np.float32(1.0)
    to = functools.partial(torch.as_tensor, device=device)
    return (to(sx), to(np.minimum(sx + 1, src_w - 1)), to(one - fx), to(fx),
            to(np.clip(sy, 0, src_h - 1)), to(np.clip(sy + 1, 0, src_h - 1)),
            to((one - fy)[:, None]), to(fy[:, None]))


def resize_linear(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """``cv2.resize(x, (w, h))`` (INTER_LINEAR) of (..., H, W) float32
    planes: ``data/resize.py::resize_linear_f32``'s arithmetic, except an
    exact halving, which is ``((a + b) + (c + d)) * 0.25`` over each 2x2
    block as OpenCV's vector code sums one channel (the level images)."""
    src_h, src_w = x.shape[-2:]
    h, w = hw
    if (h, w) == (src_h, src_w):
        return x.clone()
    if 2 * h == src_h and 2 * w == src_w:
        return ((x[..., 0::2, 0::2] + x[..., 0::2, 1::2])
                + (x[..., 1::2, 0::2] + x[..., 1::2, 1::2])) * 0.25
    sx0, sx1, ax0, ax1, sy0, sy1, ay0, ay1 = _linear_taps(src_h, src_w, h, w, str(x.device))
    rows = x.index_select(-1, sx0) * ax0 + x.index_select(-1, sx1) * ax1
    return rows.index_select(-2, sy0) * ay0 + rows.index_select(-2, sy1) * ay1


def level_image(frames: torch.Tensor, scale: float, hw: tuple[int, int]) -> torch.Tensor:
    """The pyramid level at ``scale`` of (..., H, W) float32 frames: the
    full-resolution frames blurred, then resized to ``hw``."""
    return resize_linear(gaussian_blur(frames, *blur_params(scale)), hw)


def poly_exp_kernel(n: int = POLY_N, sigma: float = POLY_SIGMA) -> np.ndarray:
    """(5, 2n+1, 2n+1) float64 correlation kernels whose outputs are the
    coefficients ``(r_y, r_x, r_yy, r_xx, r_xy)``, from OpenCV's
    ``FarnebackPrepareGaussian``: the applicability's float32 taps ``g``,
    ``x g``, ``x^2 g`` and the entries ``ig11, ig03, ig33, ig55`` of the
    inverse of its 6x6 moment matrix. Rows are y (down), columns x
    (right)."""
    x = np.arange(-n, n + 1)
    g = np.exp(-(x * x) / (2 * sigma * sigma)).astype(np.float32)
    g = (g * (1.0 / g.astype(np.float64).sum())).astype(np.float32)
    xg = (x * g).astype(np.float32).astype(np.float64)
    xxg = (x * x * g).astype(np.float32).astype(np.float64)
    g = g.astype(np.float64)
    gy, gx = np.meshgrid(g, g, indexing="ij")
    yy, xx = np.meshgrid(x.astype(np.float64), x.astype(np.float64), indexing="ij")
    big = np.zeros((6, 6))
    big[0, 0] = (gy * gx).sum()
    big[1, 1] = (gy * gx * xx * xx).sum()
    big[3, 3] = (gy * gx * xx ** 4).sum()
    big[5, 5] = (gy * gx * xx * xx * yy * yy).sum()
    big[2, 2] = big[0, 3] = big[0, 4] = big[3, 0] = big[4, 0] = big[1, 1]
    big[4, 4] = big[3, 3]
    big[3, 4] = big[4, 3] = big[5, 5]
    inv = np.linalg.inv(big)
    ig11, ig03, ig33, ig55 = inv[1, 1], inv[0, 3], inv[3, 3], inv[5, 5]
    b1, b2, b3 = np.outer(g, g), np.outer(g, xg), np.outer(xg, g)  # sums of f, x f, y f
    b4, b5, b6 = np.outer(g, xxg), np.outer(xxg, g), np.outer(xg, xg)  # x^2 f, y^2 f, x y f
    return np.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33, b1 * ig03 + b4 * ig33,
                     b6 * ig55])


@functools.lru_cache(maxsize=4)
def _poly_weight(device: str) -> torch.Tensor:
    return torch.as_tensor(poly_exp_kernel()[:, None], device=device)


def poly_exp(img: torch.Tensor) -> torch.Tensor:
    """OpenCV's ``FarnebackPolyExp`` of (..., H, W) float32 images: (..., 5,
    H, W) float32 coefficients ``(r_y, r_x, r_yy, r_xx, r_xy)`` of the
    weighted least-squares fit of ``{1, x, y, x^2, xy, y^2}`` around each
    pixel, borders replicated: one 2D correlation in float64 (OpenCV sums
    its vertical pass in float32, its horizontal one in float64)."""
    h, w = img.shape[-2:]
    n = POLY_N
    x = F.pad(img.reshape(-1, 1, h, w).double(), (n, n, n, n), mode="replicate")
    return F.conv2d(x, _poly_weight(str(img.device))).float().reshape(img.shape[:-2] + (5, h, w))


@functools.lru_cache(maxsize=64)
def _matrix_consts(h: int, w: int, device: str):
    """Of an (h, w) level, for :func:`update_matrices`: the pixel grid (2,
    h, w) ``(x, y)``, the last cell corner a sample may start from ``(w -
    1, h - 1)``, the offsets of a cell's four corners in a flattened plane,
    the border damping, and its small scale and index vectors."""
    b = len(BORDER)

    def axis(n):
        i = np.arange(n)
        lo = np.where(i < b, BORDER[np.minimum(i, b - 1)], np.float32(1))
        hi = np.where(i >= n - b, BORDER[np.clip(n - i - 1, 0, b - 1)], np.float32(1))
        inner = (i - b).astype(np.uint32) < np.uint32((n - 2 * b) & 0xFFFFFFFF)
        return lo.astype(np.float32), hi.astype(np.float32), inner

    xlo, xhi, xin = axis(w)
    ylo, yhi, yin = axis(h)
    # OpenCV's ((x_lo * x_hi) * y_lo) * y_hi, on the band only
    damp = ((xlo[None, :] * xhi[None, :]) * ylo[:, None]) * yhi[:, None]
    damp = np.where(xin[None, :] & yin[:, None], np.float32(1), damp).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32)))
    to = functools.partial(torch.as_tensor, device=device)
    return (to(grid), to(np.array([w - 1, h - 1], np.float32)[:, None, None]),
            to(np.array([0, 1, w, w + 1])[:, None]), to(damp),
            # r4, r5, r6 of a sample inside: (r0 + r1) times these; outside: r0 times these
            to(np.array([0.5, 0.5, 0.25], np.float32)[:, None, None]),
            to(np.array([1.0, 1.0, 0.5], np.float32)[:, None, None]),
            # of (r4, r5, r6): the factors of dy and of dx in r2 and r3
            to(np.array([0, 2])), to(np.array([2, 1])),
            # of (r2, r3, r4, r5, r6): G11 = r4 r4 + r6 r6, G22 = r5 r5 + r6 r6,
            # h1 = r4 r2 + r6 r3, h2 = r6 r2 + r5 r3 (G12 = (r4 + r5) r6 apart)
            to(np.array([(2, 3, 2, 4), (2, 3, 0, 0), (4, 4, 4, 3), (4, 4, 1, 1)])))


def update_matrices(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """OpenCV's ``FarnebackUpdateMatrices``: from the (5, H, W) coefficients
    of both frames and the (2, H, W) flow ``(dx, dy)``, the (5, H, W)
    fields ``(G11, G12, G22, h1, h2)`` of each pixel's normal equations,
    every float32 operation in OpenCV's order."""
    h, w = flow.shape[-2:]
    grid, last, corners, damp, quad_in, quad_out, of_dy, of_dx, terms = _matrix_consts(
        h, w, str(flow.device))
    pos = grid + flow  # (fx, fy)
    cell = torch.floor(pos)
    inside = ((cell >= 0) & (cell < last)).all(0)
    frac = pos - cell
    wts = torch.stack([1.0 - frac, frac])  # [1 - f, f] of (x, y)
    a = (wts[:, None, 1] * wts[None, :, 0]).reshape(4, h, w)  # a00, a01, a10, a11
    cell = torch.where(inside, cell, 0.0).long()
    index = ((cell[1] * w + cell[0]).reshape(1, -1) + corners).reshape(-1)
    prod = r1.reshape(5, -1).index_select(1, index).reshape(5, 4, h, w) * a
    s = ((prod[:, 0] + prod[:, 1]) + prod[:, 2]) + prod[:, 3]
    quad = torch.where(inside, (r0[2:] + s[2:]) * quad_in, r0[2:] * quad_out)  # r4, r5, r6
    lin = (r0[:2] - torch.where(inside, s[:2], 0.0)) * 0.5
    r23 = lin + (quad.index_select(0, of_dy) * flow[1] + quad.index_select(0, of_dx) * flow[0])
    r = torch.cat([r23, quad]) * damp  # r2, r3, r4, r5, r6
    f = [r.index_select(0, t) for t in terms]
    m = f[0] * f[1] + f[2] * f[3]  # G11, G22, h1, h2
    return torch.stack([m[0], (r[2] + r[3]) * r[4], m[1], m[2], m[3]])


def update_flow(mats: torch.Tensor) -> torch.Tensor:
    """OpenCV's ``FarnebackUpdateFlow_Blur``: the ``winsize`` box mean of
    the (5, H, W) fields with replicated borders, in float64 (running sums,
    as OpenCV's), then the (2, H, W) float32 flow ``G^-1 h``, the
    determinant regularised by 1e-3."""
    winsize, m = WINSIZE, WINSIZE // 2
    h, w = mats.shape[-2:]
    # one replicated row and column more above and left: a running sum's zero
    c = F.pad(mats[None].double(), (m + 1, m, m + 1, m), mode="replicate")[0].cumsum(-2)
    c = (c[:, winsize:] - c[:, :h]).cumsum(-1)
    box = (c[..., winsize:] - c[..., :w]) * (1.0 / (winsize * winsize))
    g11, g12, g22, h1, h2 = box
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet]).float()


def calc_flow(prev: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """Farneback flow between two (H, W) gray frames (uint8 or float32
    tensors, both on one device): (2, H, W) float32 ``(dx, dy)``."""
    frames = torch.stack([prev, nxt]).float()
    flow = None
    for scale, h, w in level_geometry(*frames.shape[-2:]):
        if flow is None:
            flow = frames.new_zeros((2, h, w))
        else:
            flow = resize_linear(flow, (h, w)) * (1.0 / PYR_SCALE)
        r0, r1 = poly_exp(level_image(frames, scale, (h, w)))
        mats = update_matrices(r0, r1, flow)
        for i in range(ITERATIONS):
            flow = update_flow(mats)
            if i < ITERATIONS - 1:
                mats = update_matrices(r0, r1, flow)
    return flow

