"""The learned and classical flow of the tracker benchmark (evals/flow.py),
the host formulas that replace OpenCV there (data/color.py,
data/resize.py) and ``utils/profiling.flops_of``, against OpenCV and the
JAX package's ``evals/flow.py`` on the same numpy inputs.

Tolerances: the gray conversion and the uint8 halving are byte-equal
(OpenCV's fixed point); the float32 resize is OpenCV's arithmetic and
held to 1e-6; the blur follows OpenCV 5.0.0's float32 order (bit-equal to
the x86-64 build it was fitted to, held to 1e-6); the warp, cost volume and upsampling match JAX's to
1e-6, the network's forward to 1e-5 (convs summed in another order), one
Adam step to 1e-6; Farneback flow as tests/test_torch_farneback.py holds
it (at most 0.1% of pixels off by more than 1e-3 px, none by 0.1 px).
"""

import inspect
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from snn_object_detectionddp_tpu.evals import flow as jflow
from snn_object_detectionddp_tpu_torch.convert import pwclite_params_from_jax
from snn_object_detectionddp_tpu_torch.data.color import bgr_to_gray_u8, gaussian_blur_f32
from snn_object_detectionddp_tpu_torch.data.resize import rescale_u8, resize_linear_f32
from snn_object_detectionddp_tpu_torch.evals import flow as tflow
from snn_object_detectionddp_tpu_torch.utils.profiling import flops_of


def _jax_closures():
    """The JAX network's ``_warp`` and ``_corr`` (closures of its __call__)."""
    fn = type(jflow.PWCLite().build()).__call__
    while hasattr(fn, "__wrapped__"):
        fn = fn.__wrapped__
    found = inspect.getclosurevars(fn).nonlocals
    return found["_warp"], found["_corr"]


@pytest.mark.parametrize("seed", range(3))
def test_gray_equals_cv2(seed):
    rng = np.random.RandomState(seed)
    for _ in range(20):
        img = rng.randint(0, 256, (rng.randint(1, 80), rng.randint(1, 80), 3)).astype(np.uint8)
        np.testing.assert_array_equal(bgr_to_gray_u8(img), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    ramp = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"), -1)
    for c in range(3):  # every pair of levels in two channels, the third at 0 / 255
        for fill in (0, 255):
            img = np.full((256, 256, 3), fill, np.uint8)
            img[..., [k for k in range(3) if k != c]] = ramp
            np.testing.assert_array_equal(bgr_to_gray_u8(img), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))


@pytest.mark.parametrize("seed", range(3))
def test_resize_f32_and_halving_equal_cv2(seed):
    rng = np.random.RandomState(seed)
    sizes = [((rng.randint(1, 97), rng.randint(1, 97)), (rng.randint(1, 97), rng.randint(1, 97)))
             for _ in range(30)]
    sizes += [((32, 40), (64, 80)), ((64, 80), (32, 40)), ((31, 45), (62, 90)),
              ((33, 47), (67, 93)), ((240, 320), (480, 640))]
    for (sh, sw), (h, w) in sizes:
        flow = (rng.randn(sh, sw, 2) * 8).astype(np.float32)
        np.testing.assert_allclose(resize_linear_f32(flow, (h, w)), cv2.resize(flow, (w, h)),
                                   rtol=0, atol=1e-6, err_msg=f"{(sh, sw)} -> {(h, w)}")
        gray = rng.randint(0, 256, (sh, sw)).astype(np.uint8)
        for f in (0.5, 0.25, 0.75):
            if round(sh * f) and round(sw * f):
                np.testing.assert_array_equal(rescale_u8(gray, f), cv2.resize(gray, None, fx=f, fy=f),
                                              err_msg=f"{(sh, sw)} x{f}")


def test_gaussian_blur_equals_cv2():
    rng = np.random.RandomState(0)
    for shape in ((80, 80), (72, 96), (40, 30), (13, 13)):
        img = rng.rand(*shape).astype(np.float32)
        np.testing.assert_allclose(gaussian_blur_f32(img, 3.0),
                                   cv2.GaussianBlur(img, (0, 0), 3.0), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="more than 12"):
        gaussian_blur_f32(np.zeros((12, 40), np.float32), 3.0)


def test_warp_corr_upsample_match_jax():
    jwarp, jcorr = _jax_closures()
    rng = np.random.RandomState(1)
    feat = rng.randn(12, 20, 16).astype(np.float32)
    f2 = rng.randn(12, 20, 16).astype(np.float32)
    flow = (rng.randn(12, 20, 2) * 4).astype(np.float32)  # reaches past every border
    got = tflow._warp(torch.from_numpy(feat), torch.from_numpy(flow)).numpy()
    np.testing.assert_allclose(got, np.asarray(jwarp(jnp.asarray(feat), jnp.asarray(flow))),
                               rtol=0, atol=1e-6)
    got = tflow._corr(torch.from_numpy(feat), torch.from_numpy(f2), tflow.PWCLite.RADIUS).numpy()
    want = np.asarray(jcorr(jnp.asarray(feat), jnp.asarray(f2)))
    assert got.shape == want.shape == (12, 20, 49)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    small = rng.randn(6, 10, 2).astype(np.float32)
    for hw in ((12, 20), (24, 40)):
        np.testing.assert_allclose(
            tflow._upsample(torch.from_numpy(small), hw).numpy(),
            np.asarray(jax.image.resize(jnp.asarray(small), hw + (2,), "bilinear")),
            rtol=0, atol=1e-6)


def _carried(hw, seed=0):
    """The JAX network, its seeded params and the port's network holding them."""
    net = jflow.PWCLite().build()
    z = jnp.zeros(hw, jnp.float32)
    params = jax.jit(net.init)(jax.random.PRNGKey(seed), z, z)
    port = tflow.PWCLite()
    port.load_state_dict(pwclite_params_from_jax(jax.tree.map(np.asarray, params), "cpu"))
    return net, params, port


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_pwclite_forward_matches_flax(hw):
    net, params, port = _carried(hw)
    rng = np.random.RandomState(2)
    a = gaussian_blur_f32(rng.rand(*hw).astype(np.float32), 2.0)
    b = np.roll(a, (1, 3), axis=(0, 1))
    want = np.asarray(jax.jit(net.apply)(params, jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = port(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == hw + (2,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_adam_step_matches_optax():
    """One fit step (the endpoint loss, its gradient, Adam at lr 1e-3) on
    the same params and the same pair; the pair is the one JAX's
    fit_translations draws (its blur by OpenCV, the port's by
    gaussian_blur_f32)."""
    hw, lr = (32, 32), 1e-3
    net, params, _ = _carried(hw, seed=3)
    # the JAX package's draw, as fit_translations makes it
    rng = np.random.RandomState(0)
    base = cv2.GaussianBlur(rng.rand(48, 48).astype(np.float32), (0, 0), 3.0)
    base = (base - base.min()) / max(float(np.ptp(base)), 1e-6)
    dx, dy = rng.randint(-4, 5), rng.randint(-4, 5)
    a, b = base[8:40, 8:40], base[8 - dy: 40 - dy, 8 - dx: 40 - dx]
    gt = np.full(hw + (2,), (dx, dy), np.float32)
    ta, tb, tgt = tflow.translation_pair(np.random.RandomState(0), *hw)
    np.testing.assert_array_equal(tgt, gt)
    np.testing.assert_allclose(ta, a, atol=1e-6)
    np.testing.assert_allclose(tb, b, atol=1e-6)

    tx = optax.adam(lr)
    loss_fn = lambda p: jnp.mean(jnp.abs(net.apply(p, jnp.asarray(a), jnp.asarray(b)) - gt))  # noqa: E731
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    updates, _ = tx.update(grads, tx.init(params))
    want = pwclite_params_from_jax(jax.tree.map(np.asarray, optax.apply_updates(params, updates)),
                                   "cpu")

    mf = tflow.ModelFlow(device="cpu")
    mf.net.load_state_dict(pwclite_params_from_jax(jax.tree.map(np.asarray, params), "cpu"))
    opt = tflow.Optimizer(weight_decay=0.0, grad_clip_norm=float("inf"))
    state, got_loss = mf.fit_step(opt, opt.init(dict(mf.net.named_parameters())), a, b, gt, lr)
    assert state["count"] == 1
    assert got_loss == pytest.approx(float(loss), rel=1e-6)
    got = mf.net.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_fit_translations_runs_and_trains():
    mf = tflow.ModelFlow(device="cpu")
    with pytest.warns(RuntimeWarning, match="untrained"):
        mf.compute(np.zeros((16, 16), np.uint8), np.zeros((16, 16), np.uint8))
    err = mf.fit_translations(steps=3, size=16)
    assert np.isfinite(err) and mf._trained


def test_boxes_and_farneback_flops_equal_jax():
    rng = np.random.RandomState(4)
    for _ in range(30):
        h, w = rng.randint(8, 60, 2)
        flow = (rng.randn(h, w, 2) * 3).astype(np.float32)
        flow[rng.rand(h, w) < 0.05] = np.nan
        xy = rng.rand(5, 2) * [w, h] - 5
        boxes = np.concatenate([xy, xy + rng.rand(5, 2) * 30], 1).astype(np.float32)
        np.testing.assert_array_equal(tflow.update_bounding_boxes(boxes, flow),
                                      jflow.update_bounding_boxes(boxes, flow))
    assert tflow.update_bounding_boxes(boxes, None) is boxes
    for kw in ({}, {"levels": 4}, {"winsize": 31}, {"iterations": 6, "poly_n": 7}):
        assert tflow.farneback_flops_per_pixel(**kw) == jflow.farneback_flops_per_pixel(**kw)
    assert tflow.FARNEBACK_FLOPS_PER_PIXEL == jflow.FARNEBACK_FLOPS_PER_PIXEL
    assert (tflow.flow_flops_per_frame("farneback", 100, 100, 0.5, device="cpu")
            == jflow.flow_flops_per_frame("farneback", 100, 100, 0.5))
    assert tflow.flow_flops_per_frame("no", 48, 64, device="cpu") == 0.0


def test_farneback_equals_jax_and_needs_cv2(monkeypatch):
    """The port computes Farneback itself (evals/farneback.py): it equals
    the JAX package's (OpenCV) within the tolerances of
    tests/test_torch_farneback.py and runs with OpenCV blocked."""
    rng = np.random.RandomState(0)
    base = (rng.rand(64, 80) * 255).astype(np.uint8)
    shifted = np.roll(base, 3, axis=1)
    frames = [rng.randint(0, 256, (48, 64, 3)).astype(np.uint8) for _ in range(2)]
    want = [jflow.farneback_flow(base, shifted, ds) for ds in (1.0, 0.5)]
    want.append(jflow.get_optical_flow(*frames, "farneback", 0.5))
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = [tflow.farneback_flow(base, shifted, ds, device="cpu") for ds in (1.0, 0.5)]
    got.append(tflow.get_optical_flow(*frames, "farneback", 0.5, device="cpu"))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        diff = np.abs(g - w).max(-1)
        assert (diff > 1e-3).mean() <= 1e-3 and diff.max() <= 0.1
    with pytest.raises(ValueError, match="not available"):
        tflow.get_optical_flow(*frames, "lucas_kanade", device="cpu")


def test_flops_of_counts_convs_and_flow_scales_with_area():
    x = torch.zeros(1, 3, 20, 24)
    w = torch.zeros(8, 3, 3, 3)
    k, cin, cout, ho, wo = 3, 3, 8, 10, 12
    got = flops_of(lambda a, b: torch.nn.functional.conv2d(a, b, stride=2, padding=1), x, w)
    assert got == 2 * k * k * cin * cout * ho * wo
    mf = tflow.get_model_flow("cpu")
    f1, f2 = mf.flops(48, 64), mf.flops(96, 128)
    assert f1 > 1e6 and f2 == pytest.approx(4 * f1, rel=0.02)
    assert tflow.flow_flops_per_frame("model", 96, 128, 0.5, device="cpu") == f1


def test_profiling_helpers(tmp_path):
    """``trace`` writes a Chrome/Perfetto JSON of the block's operators
    with the tracer's spans merged in, and ``gaps.json``; the tracer
    records only while the profiler (or ``enable``) is on."""
    import json

    from snn_object_detectionddp_tpu_torch.utils import profiling

    profiling.reset()
    with profiling.span("before"):
        pass
    with profiling.trace(tmp_path / "prof") as prof:
        with profiling.span("conv.phase", layer=1):
            torch.nn.functional.conv2d(torch.ones(1, 1, 8, 8), torch.ones(2, 1, 3, 3))
    with profiling.span("after"):
        pass
    try:
        events = json.loads((tmp_path / "prof/trace.json").read_text())["traceEvents"]
        assert any("conv" in e.get("name", "") for e in events)
        assert any("conv" in e.key for e in prof.key_averages())
        (merged,) = [e for e in events if e.get("cat") == "program_span"]
        assert merged["name"] == "conv.phase" and merged["args"]["layer"] == 1
        assert [s["name"] for s in profiling.spans()] == ["conv.phase"]
        assert (tmp_path / "prof/gaps.json").exists()
    finally:
        profiling.reset()