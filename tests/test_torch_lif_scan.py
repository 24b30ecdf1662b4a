"""The port's plain LIF scan (models/lif.py::run_lif on CPU tensors: the
plain versions of the ``lif_scan_*`` CUDA kernels, tied by an autograd
function) against the JAX package on the same numpy inputs and cotangents:
``lif_scan_pallas`` in interpret mode and the XLA ``lif_scan``.

Tolerances and their reasons:
- fp32: spikes equal; membranes and gradients atol 1e-5 — the same fp32
  recurrence on both sides, XLA may contract multiply-adds (the bound of
  tests/test_pallas.py).
- bf16 against the Pallas kernel: spikes equal, v_final atol 1e-5; the
  kernel and the port both save v_pre rounded to bf16 and run the same
  backward on it. dx is rounded to bf16 (one ulp, relative 2^-7); a v_pre
  that XLA's contracted multiply-add moves by an fp32 ulp can round to the
  neighbouring bf16 value and move the surrogate by as much, so dv0 gets
  the same relative bound.
- bf16 against the XLA scan, which keeps v_pre in fp32: gradients within 2%
  of the largest reference gradient and 1e-3 of it on average — the bound
  tests/test_pallas.py::test_bf16_currents_match_scan holds the Pallas
  kernel to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_object_detectionddp_tpu.kernels.lif_pallas import lif_scan_pallas
from snn_object_detectionddp_tpu.models import lif as jlif
from snn_object_detectionddp_tpu_torch.models import lif as tlif

ATOL = 1e-5
RESETS = {
    "soft": dict(threshold=1.0, decay=0.5, surrogate_slope=4.0, reset="soft"),
    "hard": dict(threshold=0.7, decay=0.9, surrogate_slope=2.0, reset="hard"),
}
# (T, ...) shapes: the odd sizes of the JAX package's own test (its kernel
# pads them), a 5-D model-like shape, a 1-D state, a single step.
SHAPES = [(4, 3, 50, 70), (3, 2, 6, 5, 16), (5, 33), (1, 2, 7, 9)]
SHAPE_IDS = ["odd_3x50x70", "tbhwc", "flat_33", "one_step"]


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return dict(
        x=(rng.randn(*shape) * 1.3).astype(np.float32),
        v0=(0.3 * rng.randn(*shape[1:])).astype(np.float32),
        g_s=rng.randn(*shape).astype(np.float32),
        g_v=rng.randn(*shape[1:]).astype(np.float32),
    )


def _jax_run(fn, d, dtype):
    (s, v), vjp = jax.vjp(fn, jnp.asarray(d["x"], dtype), jnp.asarray(d["v0"]))
    gx, gv = vjp((jnp.asarray(d["g_s"], dtype), jnp.asarray(d["g_v"])))
    return [np.asarray(a, np.float32) for a in (s, v, gx, gv)]


def _port_run(d, p, dtype, x_view=None):
    x = torch.from_numpy(d["x"]).to(dtype).requires_grad_()
    v0 = torch.from_numpy(d["v0"]).requires_grad_()
    s, v = tlif.run_lif(x if x_view is None else x_view(x), p, v0)
    assert s.dtype == dtype and v.dtype == torch.float32
    gx, gv = torch.autograd.grad(
        (s, v), (x, v0), (torch.from_numpy(d["g_s"]).to(dtype), torch.from_numpy(d["g_v"])))
    assert gx.dtype == dtype and gv.dtype == torch.float32
    return [a.detach().float().numpy() for a in (s, v, gx, gv)]


@pytest.mark.parametrize("reset", ["soft", "hard"])
@pytest.mark.parametrize("ref", ["pallas_interpret", "xla_scan"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_run_lif_matches_jax_fp32(shape, ref, reset):
    d = _inputs(shape, seed=len(shape))
    jp = jlif.LIFParams(**RESETS[reset])
    if ref == "xla_scan":
        fn = lambda x, v0: jlif.lif_scan(x, jp, v0)  # noqa: E731
    else:
        fn = lambda x, v0: lif_scan_pallas(x, v0, jp, True)  # noqa: E731
    s_j, v_j, gx_j, gv_j = _jax_run(fn, d, jnp.float32)
    s_t, v_t, gx_t, gv_t = _port_run(d, tlif.LIFParams(**RESETS[reset]), torch.float32)
    np.testing.assert_array_equal(s_t, s_j)
    assert 0.02 < s_t.mean() < 0.9  # the inputs do make the neurons fire
    np.testing.assert_allclose(v_t, v_j, atol=ATOL)
    np.testing.assert_allclose(gx_t, gx_j, atol=ATOL)
    np.testing.assert_allclose(gv_t, gv_j, atol=ATOL)


@pytest.mark.parametrize("reset", ["soft", "hard"])
@pytest.mark.parametrize("shape", [(4, 2, 32, 128), (4, 3, 50, 70)], ids=["lanes", "odd"])
def test_run_lif_matches_pallas_bf16(shape, reset):
    d = _inputs(shape, seed=3)
    jp = jlif.LIFParams(**RESETS[reset])
    s_j, v_j, gx_j, gv_j = _jax_run(lambda x, v0: lif_scan_pallas(x, v0, jp, True), d,
                                    jnp.bfloat16)
    s_t, v_t, gx_t, gv_t = _port_run(d, tlif.LIFParams(**RESETS[reset]), torch.bfloat16)
    np.testing.assert_array_equal(s_t, s_j)
    np.testing.assert_allclose(v_t, v_j, atol=ATOL)
    np.testing.assert_allclose(gx_t, gx_j, rtol=2 ** -7, atol=ATOL)
    np.testing.assert_allclose(gv_t, gv_j, rtol=2 ** -7, atol=ATOL)


def test_run_lif_bf16_gradients_within_the_jax_bound_of_the_scan():
    d = _inputs((4, 2, 32, 128), seed=3)
    jp = jlif.LIFParams(**RESETS["soft"])
    s_j, v_j, gx_j, _ = _jax_run(lambda x, v0: jlif.lif_scan(x, jp, v0), d, jnp.bfloat16)
    s_t, v_t, gx_t, _ = _port_run(d, tlif.LIFParams(**RESETS["soft"]), torch.bfloat16)
    np.testing.assert_array_equal(s_t, s_j)
    np.testing.assert_allclose(v_t, v_j, atol=ATOL)
    diff, scale = np.abs(gx_t - gx_j), np.abs(gx_j).max()
    assert diff.max() <= 0.02 * scale
    assert diff.mean() <= 1e-3 * scale


@pytest.mark.parametrize("reset", ["soft", "hard"])
def test_run_lif_default_v0_and_no_grad(reset):
    """v0=None is a zero membrane (as the JAX run_lif), and without a
    gradient the forward gives the same spikes and membrane as with one."""
    d = _inputs((3, 2, 9, 11), seed=5)
    p = tlif.LIFParams(**RESETS[reset])
    s_j, v_j = jlif.run_lif(jnp.asarray(d["x"]), jlif.LIFParams(**RESETS[reset]))
    x = torch.from_numpy(d["x"])
    s_t, v_t = tlif.run_lif(x, p)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=ATOL)
    s_g, v_g = tlif.run_lif(x.clone().requires_grad_(), p)
    assert s_g.requires_grad and not s_t.requires_grad
    assert torch.equal(s_g, s_t) and torch.equal(v_g, v_t)
    # the port's own differentiable scan is the same function
    s_s, v_s = tlif.lif_scan(x, p)
    assert torch.equal(s_s, s_t)
    np.testing.assert_allclose(v_s.numpy(), v_t.numpy(), atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_run_lif_non_contiguous_input(dtype):
    """A strided view (here a transpose of the two spatial axes) gives what
    its contiguous copy gives, forward and gradients."""
    d = _inputs((4, 2, 6, 10), seed=7)
    p = tlif.LIFParams(**RESETS["soft"])
    dt = {k: np.ascontiguousarray(np.swapaxes(v, -1, -2)) for k, v in d.items()}
    want = _port_run(dt, p, dtype)
    got = _port_run({**d, "v0": dt["v0"], "g_s": dt["g_s"], "g_v": dt["g_v"]}, p, dtype,
                    x_view=lambda x: x.transpose(-1, -2))
    assert not torch.from_numpy(d["x"]).transpose(-1, -2).is_contiguous()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(np.swapaxes(got[2], -1, -2), want[2])
    np.testing.assert_array_equal(got[3], want[3])


def test_plain_versions_are_what_run_lif_uses():
    """lif_forward_reference / lif_backward_reference (the functions the
    kernels are held against on the card) give run_lif's outputs; an unused
    output's cotangent arrives as None and counts as zeros."""
    d = _inputs((3, 4, 5), seed=9)
    p = tlif.LIFParams(**RESETS["hard"])
    x, v0 = torch.from_numpy(d["x"]).bfloat16(), torch.from_numpy(d["v0"])
    s, vpre, vfin = tlif.lif_forward_reference(x, p, v0, with_residuals=True)
    assert vpre.dtype == torch.bfloat16 and vfin.dtype == torch.float32
    s2, none, vfin2 = tlif.lif_forward_reference(x, p, v0)
    assert none is None and torch.equal(s, s2) and torch.equal(vfin, vfin2)
    g_s = torch.from_numpy(d["g_s"]).bfloat16()
    g_x, g_v0 = tlif.lif_backward_reference(vpre, g_s, torch.zeros_like(v0), p)
    xr, vr = x.clone().requires_grad_(), v0.clone().requires_grad_()
    s3, _ = tlif.run_lif(xr, p, vr)
    got = torch.autograd.grad(s3, (xr, vr), g_s)
    assert torch.equal(s3, s) and torch.equal(got[0], g_x) and torch.equal(got[1], g_v0)


def test_run_lif_rejects_bad_inputs():
    x = torch.zeros(2, 3, 4)
    p = tlif.LIFParams()
    with pytest.raises(ValueError, match="v0 must be"):
        tlif.run_lif(x, p, torch.zeros(4, 3))
    with pytest.raises(ValueError, match="v0 must be"):
        tlif.run_lif(x, p, torch.zeros(3, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="bf16/f32"):
        tlif.run_lif(x.half(), p)
    with pytest.raises(ValueError, match="reset"):
        tlif.run_lif(x, tlif.LIFParams(reset="none"))
