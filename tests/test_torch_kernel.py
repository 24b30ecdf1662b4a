"""The hand-written CUDA normalize+LIF kernel against its plain PyTorch
version, on the card. Every test here needs an NVIDIA GPU and skips with
a reason elsewhere. The file imports no JAX, so on a card machine it runs
without the JAX stack:

    python -m pytest tests/test_torch_kernel.py -m cuda --noconftest -q

Tolerance: the kernel performs the same rounded fp32 operations as the
plain version (no contracted multiply-adds), so outputs must be equal.
"""

import numpy as np
import pytest
import torch

from snn_object_detectionddp_tpu_torch.kernels import affine_lif as K
from snn_object_detectionddp_tpu_torch.models.lif import LIFParams, affine_lif_tb_reference

PARAMS = [LIFParams(), LIFParams(threshold=0.7, decay=0.9, reset="hard")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _inputs(t, b, h, w, c, dtype, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(t * b, h, w, c) * 1.2).astype(np.float32)).to(dtype)
    a = torch.from_numpy((1.0 + 0.3 * rng.randn(t, b, c)).astype(np.float32))
    bb = torch.from_numpy((0.2 * rng.randn(t, b, c)).astype(np.float32))
    v0 = torch.from_numpy((0.3 * rng.randn(b, h, w, c)).astype(np.float32))
    return x, a, bb, v0


@pytest.mark.cuda
@pytest.mark.parametrize("p", PARAMS, ids=["soft", "hard"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(1, 2, 15, 20, 512), (3, 2, 7, 9, 24), (2, 1, 3, 5, 7)],
                         ids=["vec", "vec_odd_hw", "scalar_c"])
@pytest.mark.parametrize("readouts", [False, True])
def test_kernel_equals_plain(cuda_device, p, dtype, shape, readouts):
    args = [t.to(cuda_device) for t in _inputs(*shape, dtype)]
    before = K.launch_count
    got = K.affine_lif_fwd(args[0], args[1], args[2], p, args[3], readouts)
    ref = affine_lif_tb_reference(args[0], args[1], args[2], p, args[3], readouts)
    assert K.launch_count == before + 1
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.cuda
def test_unaligned_view_takes_scalar_path(cuda_device):
    """A batch slice at an odd offset breaks 32-byte alignment; the kernel
    must fall back to its scalar path and still be exact."""
    x, a, b, v0 = (t.to(cuda_device) for t in _inputs(1, 3, 4, 5, 8, torch.bfloat16))
    xs = x.reshape(-1)[8:8 + 160].reshape(1, 4, 5, 8)  # 16-byte offset view
    vs = v0.reshape(-1)[4:4 + 160].reshape(1, 4, 5, 8)
    got = K.affine_lif_fwd(xs, a[:, :1].contiguous(), b[:, :1].contiguous(), LIFParams(), vs)
    ref = affine_lif_tb_reference(xs, a[:, :1], b[:, :1], LIFParams(), vs)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda_device):
    x, a, b, v0 = (t.to(cuda_device) for t in _inputs(2, 1, 4, 6, 8, torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        K.affine_lif_fwd(x.transpose(1, 2), a, b, LIFParams(), v0.transpose(1, 2))
    with pytest.raises(ValueError, match="bf16/f32"):
        K.affine_lif_fwd(x.half(), a, b, LIFParams(), v0)
    with pytest.raises(ValueError, match="fp32"):
        K.affine_lif_fwd(x, a.double(), b, LIFParams(), v0)
    with pytest.raises(ValueError, match="match"):
        K.affine_lif_fwd(x[:1], a, b, LIFParams(), v0)
