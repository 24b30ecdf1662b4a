"""The port's Farneback flow (evals/farneback.py, evals/flow.py::
farneback_flow) against OpenCV's ``calcOpticalFlowFarneback``, which the
JAX package's ``evals/flow.py::farneback_flow`` calls, stage by stage and
whole, on the CPU.

Tolerances:
- level sizes: equal (the count of levels as OpenCV's output shows it);
- level images: OpenCV's blur rounds after each pass in float32 (with
  fused multiply-adds in its vector code), the port's once from float64,
  so the blurred image is held to 6 ulp (4 measured); the resize is
  OpenCV's own arithmetic and equal to it with Intel IPP off (IPP takes
  OpenCV's 1-channel float resize at some odd sizes);
- polynomial expansion: a float64 weighted least-squares fit to 1e-6 of
  the largest coefficient;
- matrix update: bit-equal to a per-pixel float32 transcription of
  OpenCV's loop; flow update: a float64 direct box sum to 1e-6;
- the whole flow against the JAX package's: at most 0.1% of pixels off by
  more than 1e-3 px in either component, none by more than 0.1 px.
"""

import sys

import cv2
import numpy as np
import pytest
import torch
from numpy.lib.stride_tricks import sliding_window_view

from snn_object_detectionddp_tpu.evals import flow as jflow
from snn_object_detectionddp_tpu_torch.data.resize import resize_linear_f32
from snn_object_detectionddp_tpu_torch.evals import farneback as fb
from snn_object_detectionddp_tpu_torch.evals import flow as tflow

PX_TOL = 1e-3  # px, the bound on all but FRAC_OFF of the pixels
FRAC_OFF = 1e-3
MAX_TOL = 0.1  # px, the bound on every pixel
BLUR_ULP = 6


def _textured(h, w, dx, dy, seed=0):
    """A pair of uint8 frames: smooth seeded texture and the same texture
    moved by (dx, dy), sampled bilinearly (sub-pixel shifts included)."""
    rng = np.random.RandomState(seed)
    base = cv2.GaussianBlur(rng.rand(h + 40, w + 40), (0, 0), 2.0)
    base = (base - base.min()) / np.ptp(base) * 255

    def sample(y, x):
        y0, x0 = np.floor(y).astype(int), np.floor(x).astype(int)
        fy, fx = y - y0, x - x0
        return ((1 - fy) * ((1 - fx) * base[y0, x0] + fx * base[y0, x0 + 1])
                + fy * ((1 - fx) * base[y0 + 1, x0] + fx * base[y0 + 1, x0 + 1]))

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64) + 20
    u8 = lambda a: np.clip(np.rint(a), 0, 255).astype(np.uint8)  # noqa: E731
    return u8(sample(ys, xs)), u8(sample(ys - dy, xs - dx))


def _assert_flow_close(got, want, tag):
    assert got.shape == want.shape and got.dtype == np.float32, tag
    diff = np.abs(got - want).max(-1)
    assert np.isfinite(got).all(), tag
    assert (diff > PX_TOL).mean() <= FRAC_OFF, f"{tag}: {(diff > PX_TOL).mean():.2e} off"
    assert diff.max() <= MAX_TOL, f"{tag}: max |d| {diff.max():.2e}"


def _ulps(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("hw, sizes", [
    ((240, 320), [(60, 80), (120, 160), (240, 320)]),
    ((64, 80), [(32, 40), (64, 80)]),
    ((75, 101), [(38, 50), (75, 101)]),
])
def test_level_sizes_follow_cv2(hw, sizes):
    """The sizes OpenCV's rule gives, and the number of levels as OpenCV
    shows it: asking for more levels than the rule keeps changes nothing,
    one fewer changes the flow."""
    torch.set_num_threads(1)
    assert [(h, w) for _, h, w in fb.level_geometry(*hw)] == sizes
    assert [s for s, _, _ in fb.level_geometry(*hw)] == [0.5 ** k for k in range(len(sizes))][::-1]
    a, b = _textured(*hw, 2.5, -1.5, seed=1)
    flow = {n: cv2.calcOpticalFlowFarneback(a, b, None, 0.5, n, 15, 3, 5, 1.2, 0)
            for n in (len(sizes) - 2, len(sizes) - 1, len(sizes))}
    np.testing.assert_array_equal(flow[len(sizes) - 1], flow[len(sizes)])
    assert not np.array_equal(flow[len(sizes) - 2], flow[len(sizes) - 1])
    assert len(fb.level_geometry(*hw, levels=len(sizes) - 2)) == len(sizes) - 1


@pytest.mark.parametrize("hw", [(240, 320), (75, 101), (480, 640)])
def test_level_image_matches_cv2(hw):
    torch.set_num_threads(1)
    img = np.random.RandomState(2).randint(0, 256, hw).astype(np.float32)
    ipp = cv2.ipp.useIPP()
    try:
        cv2.ipp.setUseIPP(False)
        for scale, h, w in fb.level_geometry(*hw, levels=4):
            k, sigma = fb.blur_params(scale)
            assert k == max(round(sigma * 5) | 1, 3) and k % 2 == 1
            want_blur = cv2.GaussianBlur(img, (k, k), sigma, sigma)
            got_blur = fb.gaussian_blur(torch.from_numpy(img), k, sigma).numpy()
            if scale == 1.0:  # sigma 0: OpenCV's fixed [1, 2, 1] / 4, exact on integers
                np.testing.assert_array_equal(got_blur, want_blur)
            assert _ulps(got_blur, want_blur) <= BLUR_ULP, (hw, scale)
            np.testing.assert_array_equal(
                fb.resize_linear(torch.from_numpy(want_blur), (h, w)).numpy(),
                cv2.resize(want_blur, (w, h)), err_msg=f"{hw} level {scale}")
            got = fb.level_image(torch.from_numpy(img), scale, (h, w)).numpy()
            assert got.shape == (h, w)
            assert _ulps(got, cv2.resize(want_blur, (w, h))) <= BLUR_ULP, (hw, scale)
    finally:
        cv2.ipp.setUseIPP(ipp)


def test_resize_linear_equals_host_resize():
    """The flow's upsampling on the device is ``resize_linear_f32``, and
    so is any resize but an exact halving (checked on one channel above)."""
    torch.set_num_threads(1)
    rng = np.random.RandomState(3)
    for (sh, sw), (h, w) in [((240, 320), (480, 640)), ((60, 80), (120, 160)),
                             ((38, 50), (75, 101)), ((75, 101), (38, 50)), ((33, 47), (67, 93))]:
        field = (rng.randn(sh, sw, 2) * 8).astype(np.float32)
        got = fb.resize_linear(torch.from_numpy(field).permute(2, 0, 1), (h, w))
        np.testing.assert_array_equal(got.permute(1, 2, 0).numpy(),
                                      resize_linear_f32(field, (h, w)))


def _least_squares(img, n, sigma):
    """(r_y, r_x, r_yy, r_xx, r_xy) of the float64 weighted least-squares
    fit of {1, x, y, x^2, xy, y^2} in each (2n+1)^2 window, Gaussian
    applicability of ``sigma``, edge-replicated image."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    a = np.exp(-x * x / (2 * sigma * sigma))
    wts = np.outer(a, a).ravel()
    yy, xx = np.meshgrid(x, x, indexing="ij")
    basis = np.stack([np.ones_like(xx), xx, yy, xx * xx, xx * yy, yy * yy], -1).reshape(-1, 6)
    proj = np.linalg.solve(basis.T @ (wts[:, None] * basis), (basis * wts[:, None]).T)
    win = sliding_window_view(np.pad(img.astype(np.float64), n, mode="edge"), (2 * n + 1,) * 2)
    c = win.reshape(*img.shape, -1) @ proj.T
    return np.stack([c[..., 2], c[..., 1], c[..., 5], c[..., 3], c[..., 4]])


@pytest.mark.parametrize("hw", [(32, 40), (37, 51)])
def test_poly_exp_is_the_weighted_least_squares_fit(hw):
    torch.set_num_threads(1)
    img = (np.random.RandomState(4).rand(*hw) * 255).astype(np.float32)
    got = fb.poly_exp(torch.from_numpy(np.stack([img, img[::-1].copy()]))).numpy()
    assert got.shape == (2, 5) + hw and got.dtype == np.float32
    for i, im in enumerate((img, img[::-1])):
        want = _least_squares(im, fb.POLY_N, fb.POLY_SIGMA)
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-6 * np.abs(want).max())


def _matrices_loop(r0, r1, flow):
    """OpenCV's FarnebackUpdateMatrices, pixel by pixel in float32."""
    f32 = np.float32
    _, h, w = flow.shape
    out = np.zeros((5, h, w), np.float32)
    b = len(fb.BORDER)
    for y in range(h):
        for x in range(w):
            dx, dy = flow[0, y, x], flow[1, y, x]
            fx, fy = f32(x) + dx, f32(y) + dy
            x1, y1 = int(np.floor(fx)), int(np.floor(fy))
            if 0 <= x1 < w - 1 and 0 <= y1 < h - 1:
                fx, fy = fx - f32(x1), fy - f32(y1)
                a00, a01 = (f32(1) - fx) * (f32(1) - fy), fx * (f32(1) - fy)
                a10, a11 = (f32(1) - fx) * fy, fx * fy
                s = [((a00 * r1[c, y1, x1] + a01 * r1[c, y1, x1 + 1]) + a10 * r1[c, y1 + 1, x1])
                     + a11 * r1[c, y1 + 1, x1 + 1] for c in range(5)]
                r2, r3 = s[0], s[1]
                r4 = (r0[2, y, x] + s[2]) * f32(0.5)
                r5 = (r0[3, y, x] + s[3]) * f32(0.5)
                r6 = (r0[4, y, x] + s[4]) * f32(0.25)
            else:
                r2 = r3 = f32(0)
                r4, r5, r6 = r0[2, y, x], r0[3, y, x], r0[4, y, x] * f32(0.5)
            r2 = (r0[0, y, x] - r2) * f32(0.5)
            r3 = (r0[1, y, x] - r3) * f32(0.5)
            r2 = r2 + (r4 * dy + r6 * dx)
            r3 = r3 + (r6 * dy + r5 * dx)
            if not (b <= x < w - b and b <= y < h - b):
                scale = ((((fb.BORDER[x] if x < b else f32(1))
                           * (fb.BORDER[w - x - 1] if x >= w - b else f32(1)))
                          * (fb.BORDER[y] if y < b else f32(1)))
                         * (fb.BORDER[h - y - 1] if y >= h - b else f32(1)))
                r2, r3, r4, r5, r6 = (v * scale for v in (r2, r3, r4, r5, r6))
            out[:, y, x] = (r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                            r4 * r2 + r6 * r3, r6 * r2 + r5 * r3)
    return out


def test_update_matrices_and_flow_match_opencv_loops():
    torch.set_num_threads(1)
    rng = np.random.RandomState(5)
    h, w = 16, 21
    r0, r1 = (rng.randn(2, 5, h, w) * [[[[20]], [[20]], [[3]], [[3]], [[2]]]]).astype(np.float32)
    flow = (rng.randn(2, h, w) * 2.5).astype(np.float32)  # some samples leave the image
    flow[:, 3, 4] = (w, h)
    mats = fb.update_matrices(*(torch.from_numpy(a) for a in (r0, r1, flow)))
    want = _matrices_loop(r0, r1, flow)
    np.testing.assert_array_equal(mats.numpy(), want)

    win = fb.WINSIZE
    m = win // 2
    padded = np.pad(want.astype(np.float64), ((0, 0), (m, m), (m, m)), mode="edge")
    box = sliding_window_view(padded, (win, win), axis=(1, 2)).sum((-1, -2)) / (win * win)
    g11, g12, g22, h1, h2 = box
    det = g11 * g22 - g12 * g12 + 1e-3
    expect = np.stack([(g11 * h2 - g12 * h1) / det, (g22 * h1 - g12 * h2) / det])
    got = fb.update_flow(torch.from_numpy(want)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, expect, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hw", [(64, 80), (75, 101), (240, 320)])
@pytest.mark.parametrize("downsample", [1.0, 0.5])
@pytest.mark.parametrize("shift", [(3, -2), (1.25, 0.6)], ids=["integer", "subpixel"])
def test_flow_matches_jax(hw, downsample, shift):
    """The port on the CPU against the JAX package's farneback_flow
    (OpenCV) on seeded textured frames, whole frames and halved."""
    torch.set_num_threads(1)
    a, b = _textured(*hw, *shift, seed=hw[0])
    want = jflow.farneback_flow(a, b, downsample)
    got = tflow.farneback_flow(a, b, downsample, device="cpu")
    _assert_flow_close(got, want, f"{hw} x{downsample} {shift}")
    inner = got[8:-8, 8:-8].reshape(-1, 2).mean(0)
    np.testing.assert_allclose(inner, shift, atol=0.25)  # it is the motion


def test_runs_without_cv2(monkeypatch):
    torch.set_num_threads(1)
    a, b = _textured(48, 64, 2, 1, seed=6)
    want = jflow.farneback_flow(a, b, 0.5)
    bgr = [np.repeat(f[..., None], 3, -1) for f in (a, b)]
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = tflow.farneback_flow(a, b, 0.5, device="cpu")
    np.testing.assert_array_equal(tflow.get_optical_flow(*bgr, "farneback", 0.5, device="cpu"),
                                  got)
    _assert_flow_close(got, want, "without cv2")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.zeros((40, 40), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        tflow.farneback_flow(a, a)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        tflow.get_optical_flow(a, a, "farneback")
