"""The port's plain normalize+LIF (models/lif.py::affine_lif_tb_reference)
against the JAX package's LIF paths on the same numpy inputs: the unrolled
XLA path, the lax.scan path, and the Pallas kernel in interpret mode. The
CUDA kernel itself is compared with this reference on the card
(tests/test_torch_kernel.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_object_detectionddp_tpu.kernels.affine_lif_pallas import (
    affine_lif_pallas,
    affine_lif_xla,
)
from snn_object_detectionddp_tpu.models import lif as jlif
from snn_object_detectionddp_tpu_torch.kernels import affine_lif as K
from snn_object_detectionddp_tpu_torch.models import lif as tlif

RESETS = {
    "soft": dict(threshold=1.0, decay=0.05, surrogate_slope=4.0, reset="soft"),
    "hard": dict(threshold=0.7, decay=0.9, surrogate_slope=2.0, reset="hard"),
}


def _inputs(t, b, h, w, c, seed=0, carried=True):
    rng = np.random.RandomState(seed)
    x = (rng.randn(t * b, h, w, c) * 1.2).astype(np.float32)
    a = (1.0 + 0.3 * rng.randn(t, b, c)).astype(np.float32)
    bb = (0.2 * rng.randn(t, b, c)).astype(np.float32)
    v0 = (rng.randn(b, h, w, c) * 0.3).astype(np.float32) if carried else None
    return x, a, bb, v0


def _port(x, a, b, v0, reset, readouts, dtype=torch.float32):
    return tlif.affine_lif_tb_reference(
        torch.from_numpy(x).to(dtype), torch.from_numpy(a), torch.from_numpy(b),
        tlif.LIFParams(**RESETS[reset]),
        None if v0 is None else torch.from_numpy(v0), readouts,
    )


def test_lif_params_defaults_match_jax():
    assert tuple(tlif.LIFParams()) == tuple(jlif.LIFParams())


@pytest.mark.parametrize("reset", ["soft", "hard"])
def test_lif_step_matches_jax(reset):
    rng = np.random.RandomState(1)
    v = rng.randn(4, 5, 6).astype(np.float32)
    x = (rng.randn(4, 5, 6) * 1.5).astype(np.float32)
    s_j, v_j = jlif.lif_step(jnp.asarray(v), jnp.asarray(x), jlif.LIFParams(**RESETS[reset]))
    s_t, v_t = tlif.lif_step(torch.from_numpy(v), torch.from_numpy(x),
                             tlif.LIFParams(**RESETS[reset]))
    # Same fp32 ops in the same order: exact.
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


@pytest.mark.parametrize("reset", ["soft", "hard"])
@pytest.mark.parametrize("readouts", [False, True])
@pytest.mark.parametrize("carried", [False, True])
def test_reference_matches_unrolled_tb(reset, readouts, carried):
    x, a, b, v0 = _inputs(3, 2, 5, 6, 16, seed=2, carried=carried)
    ref = jlif.affine_lif_unrolled_tb(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jlif.LIFParams(**RESETS[reset]),
        None if v0 is None else jnp.asarray(v0), with_readouts=readouts,
    )
    got = _port(x, a, b, v0, reset, readouts)
    assert len(got) == len(ref) == (3 if readouts else 2)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    # fp32 elementwise recurrence; XLA may contract x*a+b into an FMA,
    # hence one-ulp-scale tolerance rather than bit equality.
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-5)
    if readouts:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=1e-5)


@pytest.mark.parametrize("reset", ["soft", "hard"])
def test_reference_matches_xla_scan(reset):
    t, b, h, w, c = 4, 2, 6, 5, 8
    x, a, bb, v0 = _inputs(t, b, h, w, c, seed=3)
    s_j, v_j = affine_lif_xla(jnp.asarray(x.reshape(t, b, h, w, c)), jnp.asarray(a),
                              jnp.asarray(bb), jnp.asarray(v0), jlif.LIFParams(**RESETS[reset]))
    s_t, v_t = _port(x, a, bb, v0, reset, False)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j).reshape(t * b, h, w, c))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5)


@pytest.mark.parametrize("reset", ["soft", "hard"])
@pytest.mark.parametrize("shape", [(3, 2, 16, 8, 16), (2, 1, 10, 4, 32)])
def test_reference_matches_pallas_interpret(reset, shape):
    """The TPU kernel this port's CUDA kernel replaces, run in interpret
    mode as tests/test_affine_lif.py runs it (W*C % 128 == 0 shapes)."""
    t, b, h, w, c = shape
    x, a, bb, v0 = _inputs(t, b, h, w, c, seed=4)
    s_j, v_j = affine_lif_pallas(jnp.asarray(x.reshape(shape)), jnp.asarray(a), jnp.asarray(bb),
                                 jnp.asarray(v0), jlif.LIFParams(**RESETS[reset]), True)
    s_t, v_t = _port(x, a, bb, v0, reset, False)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j).reshape(t * b, h, w, c))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5)


def test_bf16_currents_match_jax():
    x, a, b, v0 = _inputs(4, 2, 8, 4, 32, seed=5)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = jlif.affine_lif_unrolled_tb(xb, jnp.asarray(a), jnp.asarray(b), jlif.LIFParams(),
                                      jnp.asarray(v0), with_readouts=True)
    # Same bf16 values on both sides (bf16 -> fp32 is exact).
    x_t = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = tlif.affine_lif_tb_reference(x_t, torch.from_numpy(a), torch.from_numpy(b),
                                       tlif.LIFParams(), torch.from_numpy(v0), True)
    assert got[0].dtype == got[2].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    np.testing.assert_array_equal(got[0].float().numpy(), np.asarray(ref[0], np.float32))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-5)
    # Readouts are rounded to bf16 on both sides: one bf16 ulp (2^-7 rel).
    np.testing.assert_allclose(got[2].float().numpy(), np.asarray(ref[2], np.float32),
                               rtol=2 ** -7, atol=1e-6)


def test_dispatch_by_device_on_cpu():
    x, a, b, v0 = _inputs(2, 1, 4, 4, 8, seed=6)
    args = (torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b), tlif.LIFParams(),
            torch.from_numpy(v0), True)
    before = dict(K.launch_counts)
    got = tlif.run_affine_lif_tb(*args)
    ref = tlif.affine_lif_tb_reference(*args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert K.launch_counts == before  # the CPU path never counts a launch


def test_kernel_wrapper_refuses_cpu_tensors():
    x, a, b, v0 = _inputs(1, 1, 4, 4, 8, seed=7)
    with pytest.raises(ValueError, match="CUDA"):
        K.affine_lif_fwd(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b),
                         tlif.LIFParams(), torch.from_numpy(v0))


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the card-less behaviour")
    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.models.detector import Detector

    with pytest.raises(RuntimeError, match="CUDA"):
        Detector.from_config(Config())
    with pytest.raises((RuntimeError, AssertionError)):
        torch.zeros(1, device="cuda")
