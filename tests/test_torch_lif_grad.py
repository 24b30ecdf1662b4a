"""Gradients of the port's plain, differentiable normalize+LIF
(models/lif.py: the CPU counterpart of the AffineLIF kernels, same
residuals and recurrence) against the JAX package on the same numpy inputs
and cotangents: ``jax.vjp`` of the Pallas kernel in interpret mode and of
the XLA scan path, the spike's surrogate derivative, the differentiable
``lif_scan``, and a whole ``SpikingConvBlock`` against the flax block.

Tolerances and their reasons:
- fp32, ATOL 2e-5: the same fp32 recurrence on both sides; XLA may contract
  multiply-adds and sums ``da``/``db`` in another order. It is the bound
  tests/test_affine_lif.py holds the two JAX paths to.
- bf16, 5% of the largest reference gradient: both sides save ``v_pre``
  rounded to bf16 and the reference (XLA path) keeps it in fp32 — the bound
  of tests/test_affine_lif.py::test_bf16_gradients_tolerance. Against the
  Pallas kernel, which rounds like the port, the fp32 bound holds.
- block, 1e-4 relative to the largest entry: XLA and PyTorch sum the conv
  in another order (~1e-6 relative), which moves ``v_pre`` and the
  GroupNorm statistics by that much; the soft-reset gradient is a smooth
  function of ``v_pre`` (it does not depend on which side of the threshold
  a spike fell), so it moves by the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_object_detectionddp_tpu.kernels.affine_lif_pallas import (
    affine_lif_pallas,
    affine_lif_xla,
)
from snn_object_detectionddp_tpu.models import layers as jl
from snn_object_detectionddp_tpu.models import lif as jlif
from snn_object_detectionddp_tpu_torch.convert import params_from_jax
from snn_object_detectionddp_tpu_torch.models import layers as tl
from snn_object_detectionddp_tpu_torch.models import lif as tlif

ATOL = 2e-5
RESETS = {
    "soft": dict(threshold=1.0, decay=0.05, surrogate_slope=4.0, reset="soft"),
    "hard": dict(threshold=0.7, decay=0.9, surrogate_slope=2.0, reset="hard"),
}
SHAPE = (3, 2, 10, 4, 32)  # (T, B, H, W, C), W*C % 128 == 0 for the Pallas kernel


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    t, b, h, w, c = shape
    return dict(
        x=(rng.randn(*shape) * 1.2).astype(np.float32),
        a=(1.0 + 0.3 * rng.randn(t, b, c)).astype(np.float32),
        b=(0.2 * rng.randn(t, b, c)).astype(np.float32),
        v0=(0.3 * rng.randn(b, h, w, c)).astype(np.float32),
        g_s=rng.randn(*shape).astype(np.float32),
        g_v=rng.randn(b, h, w, c).astype(np.float32),
    )


def _jax_grads(fn, d, dtype):
    x = jnp.asarray(d["x"], dtype)
    out, vjp = jax.vjp(fn, x, jnp.asarray(d["a"]), jnp.asarray(d["b"]), jnp.asarray(d["v0"]))
    grads = vjp((jnp.asarray(d["g_s"], dtype), jnp.asarray(d["g_v"])))
    return [np.asarray(o, np.float32) for o in out], [np.asarray(g, np.float32) for g in grads]


def _port_grads(d, p, dtype, fn=tlif.affine_lif_tb_reference):
    t, b = d["x"].shape[:2]
    x = torch.from_numpy(d["x"]).to(dtype).reshape((t * b,) + d["x"].shape[2:]).requires_grad_()
    a, bb, v0 = (torch.from_numpy(d[k]).requires_grad_() for k in ("a", "b", "v0"))
    s, v = fn(x, a, bb, p, v0)
    g_s = torch.from_numpy(d["g_s"]).to(dtype).reshape(x.shape)
    grads = torch.autograd.grad((s, v), (x, a, bb, v0), (g_s, torch.from_numpy(d["g_v"])))
    shape5 = d["x"].shape
    return ([s.detach().float().numpy().reshape(shape5), v.detach().numpy()],
            [grads[0].float().numpy().reshape(shape5)] + [g.numpy() for g in grads[1:]])


@pytest.mark.parametrize("reset", ["soft", "hard"])
@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
def test_affine_lif_gradients_match_jax_fp32(reset, ref):
    d = _inputs(SHAPE, seed=1)
    jp = jlif.LIFParams(**RESETS[reset])
    if ref == "xla":
        fn = lambda x, a, b, v0: affine_lif_xla(x, a, b, v0, jp)  # noqa: E731
    else:
        fn = lambda x, a, b, v0: affine_lif_pallas(x, a, b, v0, jp, True)  # noqa: E731
    out_j, g_j = _jax_grads(fn, d, jnp.float32)
    out_t, g_t = _port_grads(d, tlif.LIFParams(**RESETS[reset]), torch.float32)
    np.testing.assert_array_equal(out_t[0], out_j[0])
    np.testing.assert_allclose(out_t[1], out_j[1], atol=1e-5)
    for name, gt, gj in zip(("dx", "da", "db", "dv0"), g_t, g_j):
        np.testing.assert_allclose(gt, gj, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("reset", ["soft", "hard"])
def test_affine_lif_gradients_match_pallas_bf16(reset):
    """bf16 currents: the Pallas kernel and the port both store v_pre in
    bf16 and run the same backward on it. dx is rounded to bf16 on both
    sides (one bf16 ulp, relative); da/db/dv0 are fp32."""
    d = _inputs((4, 2, 16, 4, 32), seed=3)
    jp = jlif.LIFParams(**RESETS[reset])
    _, g_j = _jax_grads(lambda x, a, b, v0: affine_lif_pallas(x, a, b, v0, jp, True), d,
                        jnp.bfloat16)
    _, g_t = _port_grads(d, tlif.LIFParams(**RESETS[reset]), torch.bfloat16)
    np.testing.assert_allclose(g_t[0], g_j[0], rtol=2 ** -7, atol=ATOL, err_msg="dx")
    for name, gt, gj in zip(("da", "db", "dv0"), g_t[1:], g_j[1:]):
        # da/db sum ~500 terms: 1e-4 of the largest entry covers the order of summation.
        np.testing.assert_allclose(gt, gj, atol=1e-4 * max(1.0, np.abs(gj).max()), err_msg=name)


def test_affine_lif_bf16_gradients_within_the_jax_bound_of_fp32_exact():
    """Soft reset, bf16 currents, against the XLA path that keeps v_pre in
    fp32: the accepted O(bf16 eps) mismatch, bounded as the JAX package
    bounds its own kernel (5% of the largest reference gradient)."""
    d = _inputs((4, 2, 16, 4, 32), seed=3)
    jp = jlif.LIFParams(**RESETS["soft"])
    _, g_j = _jax_grads(lambda x, a, b, v0: affine_lif_xla(x, a, b, v0, jp), d, jnp.bfloat16)
    _, g_t = _port_grads(d, tlif.LIFParams(**RESETS["soft"]), torch.bfloat16)
    for name, gt, gj in zip(("da", "db", "dv0"), g_t[1:], g_j[1:]):
        assert np.abs(gt - gj).max() / max(np.abs(gj).max(), 1e-6) < 0.05, name


def test_unused_output_and_dispatch_on_cpu():
    """A cotangent autograd leaves out (v_final unused) arrives as None and
    is taken as zeros; run_affine_lif_tb on CPU tensors is the plain
    version; readouts under a gradient raise."""
    d = _inputs((2, 2, 4, 3, 8), seed=5)
    p = tlif.LIFParams()
    t, b = d["x"].shape[:2]
    x = torch.from_numpy(d["x"]).reshape((t * b,) + d["x"].shape[2:]).requires_grad_()
    a, bb, v0 = (torch.from_numpy(d[k]).requires_grad_() for k in ("a", "b", "v0"))
    g_s = torch.from_numpy(d["g_s"]).reshape(x.shape)
    s, _ = tlif.run_affine_lif_tb(x, a, bb, p, v0)
    got = torch.autograd.grad(s, (x, a, bb, v0), g_s)
    s2, v2 = tlif.affine_lif_tb_reference(x, a, bb, p, v0)
    ref = torch.autograd.grad((s2, v2), (x, a, bb, v0), (g_s, torch.zeros_like(v2)))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    with pytest.raises(NotImplementedError):
        tlif.run_affine_lif_tb(x, a, bb, p, v0, with_readouts=True)
    with torch.no_grad():
        assert len(tlif.run_affine_lif_tb(x, a, bb, p, v0, with_readouts=True)) == 3
    with pytest.raises(TypeError):
        tlif.backward_cotangents(x, v0.shape, g_s.double(), None)


def test_spike_and_surrogate_match_jax():
    v = np.linspace(-2.0, 2.0, 41).astype(np.float32)  # includes exactly 0
    g = np.random.RandomState(0).randn(41).astype(np.float32)
    for slope in (4.0, 2.0):
        s_j, vjp = jax.vjp(lambda z: jlif.spike(z, slope), jnp.asarray(v))
        vt = torch.from_numpy(v).requires_grad_()
        s_t = tlif.spike(vt, slope)
        (g_t,) = torch.autograd.grad(s_t, vt, torch.from_numpy(g))
        np.testing.assert_array_equal(s_t.detach().numpy(), np.asarray(s_j))
        np.testing.assert_allclose(g_t.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), rtol=1e-6)
        np.testing.assert_allclose(tlif.surrogate_grad(torch.from_numpy(v), slope).numpy(),
                                   np.asarray(jlif.surrogate_grad(jnp.asarray(v), slope)),
                                   rtol=1e-6)


@pytest.mark.parametrize("reset", ["soft", "hard"])
def test_lif_scan_gradients_match_jax(reset):
    """The differentiable lif_step/lif_scan (autograd through spike): the
    plain version the plain-LIF kernels will be held against."""
    rng = np.random.RandomState(7)
    x = (rng.randn(4, 2, 5, 6) * 1.3).astype(np.float32)
    v0 = (0.3 * rng.randn(2, 5, 6)).astype(np.float32)
    g_s, g_v = rng.randn(*x.shape).astype(np.float32), rng.randn(*v0.shape).astype(np.float32)
    (s_j, v_j), vjp = jax.vjp(lambda x, v0: jlif.lif_scan(x, jlif.LIFParams(**RESETS[reset]), v0),
                              jnp.asarray(x), jnp.asarray(v0))
    gx_j, gv_j = vjp((jnp.asarray(g_s), jnp.asarray(g_v)))
    xt, vt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(v0).requires_grad_()
    s_t, v_t = tlif.lif_scan(xt, tlif.LIFParams(**RESETS[reset]), vt)
    gx_t, gv_t = torch.autograd.grad((s_t, v_t), (xt, vt),
                                     (torch.from_numpy(g_s), torch.from_numpy(g_v)))
    np.testing.assert_array_equal(s_t.detach().numpy(), np.asarray(s_j))
    np.testing.assert_allclose(v_t.detach().numpy(), np.asarray(v_j), atol=1e-6)
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), atol=ATOL)
    np.testing.assert_allclose(gv_t.numpy(), np.asarray(gv_j), atol=ATOL)
    # and the scan agrees with the normalize+LIF reference at a = 1, b = 0
    flat = xt.reshape(8, 5, 6, 1)
    one, zero = torch.ones(4, 2, 1), torch.zeros(4, 2, 1)
    s_a, v_a = tlif.affine_lif_tb_reference(flat, one, zero, tlif.LIFParams(**RESETS[reset]),
                                            vt[..., None])
    gx_a, gv_a = torch.autograd.grad(
        (s_a, v_a), (xt, vt), (torch.from_numpy(g_s).reshape(8, 5, 6, 1),
                               torch.from_numpy(g_v)[..., None]))
    assert torch.equal(s_a.reshape(s_t.shape), s_t)
    np.testing.assert_allclose(gx_a.numpy(), gx_t.numpy(), atol=1e-6)
    np.testing.assert_allclose(gv_a.numpy(), gv_t.numpy(), atol=1e-6)


@pytest.mark.parametrize("stride", [1, 2])
def test_spiking_conv_block_gradients_match_flax(stride):
    t, b, hw, cin, cout = 2, 2, (8, 8), 8, 16
    rng = np.random.RandomState(11)
    x = rng.randn(t, b, *hw, cin).astype(np.float32)
    out_hw = tuple(-(-n // stride) for n in hw)
    v0 = (0.3 * rng.randn(b, *out_hw, cout)).astype(np.float32)
    g_s = rng.randn(t, b, *out_hw, cout).astype(np.float32)
    g_v = rng.randn(b, *out_hw, cout).astype(np.float32)
    jblock = jl.SpikingConvBlock(cout, jlif.LIFParams(), stride=stride, dtype=jnp.float32)
    tree = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tree = jax.tree.map(
        lambda v: (np.asarray(v) + 0.2 * rng.randn(*np.shape(v))).astype(np.float32), tree)

    out_j, vjp = jax.vjp(lambda p, x, v0: jblock.apply({"params": p}, x, v0),
                         tree, jnp.asarray(x), jnp.asarray(v0))
    gp_j, gx_j, gv0_j = vjp((jnp.asarray(g_s), jnp.asarray(g_v)))

    with torch.device("meta"):
        block = tl.SpikingConvBlock(cin, cout, tlif.LIFParams(), stride=stride,
                                    dtype=torch.float32)
    sd = {k: v.requires_grad_() for k, v in params_from_jax(tree, "cpu").items()}
    xt, vt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(v0).requires_grad_()
    s_t, v_t = torch.func.functional_call(block, sd, (xt, vt), strict=True)
    assert np.mean(s_t.detach().numpy() == np.asarray(out_j[0])) >= 0.999
    leaves = [xt, vt, sd["weight"], sd["gn_scale"], sd["gn_bias"]]
    got = torch.autograd.grad((s_t, v_t), leaves, (torch.from_numpy(g_s), torch.from_numpy(g_v)))
    want = [gx_j, gv0_j, np.asarray(gp_j["Conv_0"]["kernel"]).transpose(3, 2, 0, 1),
            gp_j["gn_scale"], gp_j["gn_bias"]]
    for name, g, r in zip(("x", "v0", "weight", "gn_scale", "gn_bias"), got, want):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * max(1.0, np.abs(r).max()),
                                   err_msg=name)
