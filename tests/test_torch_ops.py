"""The six LIF kernels as ``torch.library`` operators (kernels/ops.py).

On the CPU (no card here) each operator runs its plain version:

- ``torch.library.opcheck`` on every operator at a small shape (schema,
  autograd registration, fake tensors, AOT dispatch);
- the fake implementation's shapes, dtypes and strides against the real
  CPU outputs, in fp32 and bf16;
- the exported serving program of the tiny model (yolo11n, width 0.25,
  64x64, T=2) holds one ``snn_torch::affine_lif_fwd`` node per spiking
  block, no other LIF operator, and no operator of the plain LIF loop
  inside a spiking block.

Marked ``cuda`` (skipped without a card): on CUDA tensors each operator
launches its kernel, one launch a call, with the wrapper's outputs bit for
bit.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_leaves

from snn_object_detectionddp_tpu_torch import config as tconfig
from snn_object_detectionddp_tpu_torch.kernels import affine_lif as K
from snn_object_detectionddp_tpu_torch.kernels import lif as KL
from snn_object_detectionddp_tpu_torch.kernels import ops
from snn_object_detectionddp_tpu_torch.kernels import token_lstm as KT
from snn_object_detectionddp_tpu_torch.models.detector import Detector
from snn_object_detectionddp_tpu_torch.models.layers import SpikingConvBlock
from snn_object_detectionddp_tpu_torch.models.lif import LIFParams
from snn_object_detectionddp_tpu_torch.utils.export import build_serving_fn

T, B, H, W, C = 3, 2, 4, 5, 8
P = LIFParams(threshold=0.7, decay=0.6, surrogate_slope=4.0, reset="soft")


def _args(case, dtype, device="cpu", seed=0):
    """Seeded arguments of one operator call; per-step tensors in ``dtype``,
    membranes and affine coefficients fp32."""
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0, dt=torch.float32):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32)).to(device, dt)

    x4, x_t = t(T * B, H, W, C, scale=1.2, dt=dtype), t(T, B * H * W * C, scale=1.2, dt=dtype)
    a, b = 1.0 + t(T, B, C, scale=0.3), t(T, B, C, scale=0.2)
    v0, v0_flat = t(B, H, W, C, scale=0.3), t(B * H * W * C, scale=0.3)
    return {
        "affine_lif_fwd": (x4, a, b, v0, *P, False),
        "affine_lif_fwd+readouts": (x4, a, b, v0, *P, True),
        "affine_lif_fwd_res": (x4, a, b, v0, *P),
        "affine_lif_bwd": (t(T * B, H, W, C, dt=dtype), x4, a, t(T * B, H, W, C, dt=dtype),
                           t(B, H, W, C), *P),
        "lif_scan_fwd": (x_t, v0_flat, *P),
        "lif_scan_fwd_res": (x_t, v0_flat, *P),
        "lif_scan_bwd": (t(T, B * H * W * C, dt=dtype), t(T, B * H * W * C, dt=dtype),
                         t(B * H * W * C), *P),
    }[case]


CASES = ["affine_lif_fwd", "affine_lif_fwd+readouts", "affine_lif_fwd_res", "affine_lif_bwd",
         "lif_scan_fwd", "lif_scan_fwd_res", "lif_scan_bwd"]


def _op(case):
    return getattr(ops, case.split("+")[0])


def test_six_operators_in_one_namespace():
    names = {op._qualname for op in ops.OPS}
    assert names == {f"snn_torch::{n}" for n in (*K.KERNELS, *KL.KERNELS, *KT.KERNELS)}
    for name in (*K.KERNELS, *KL.KERNELS, *KT.KERNELS):
        assert hasattr(torch.ops.snn_torch, name)


@pytest.mark.parametrize("case", CASES)
def test_opcheck(case):
    torch.library.opcheck(_op(case), _args(case, torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES)
def test_fake_outputs_match_the_cpu_outputs(case, dtype):
    args = _args(case, dtype)
    real = _op(case)(*args)
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        fake = _op(case)(*fake_args)
    assert len(real) == len(fake)
    for r, f in zip(real, fake):
        assert (f.shape, f.dtype, f.stride()) == (r.shape, r.dtype, r.stride())
    if case == "affine_lif_fwd":  # readouts not asked for: an empty tensor
        assert real[2].numel() == 0


@pytest.fixture(scope="module")
def serving_graph():
    cfg = tconfig.Config()
    cfg.model.num_classes = 2
    cfg.model.yolo_model_name = "yolo11n.pt"
    cfg.model.width_mult = 0.25
    cfg.model.hyp.reg_max = 8
    cfg.model.timesteps = 2
    cfg.model.image_size = (64, 64)
    cfg.runtime.precision = "f32"
    det = Detector.from_config(cfg, device="cpu")
    program = torch.export.export(
        build_serving_fn(det, det.init_params(), conf=0.0),
        (torch.zeros((1, 2, 64, 64, 3), dtype=torch.uint8),), strict=False)
    blocks = sum(isinstance(m, SpikingConvBlock) for m in det.module.modules())
    return program.graph, blocks


def test_exported_serving_graph_holds_one_lif_operator_per_spiking_block(serving_graph):
    graph, blocks = serving_graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    lif_nodes = [t for t in targets if t.startswith("snn_torch.")]
    assert blocks == 17 and lif_nodes == ["snn_torch.affine_lif_fwd.default"] * blocks
    # The plain loop would add, inside each block, a threshold compare and
    # the concatenation of its steps.
    in_blocks = {str(n.target) for n in graph.nodes if n.op == "call_function"
                 and list(n.meta["nn_module_stack"].values())[-1][1].endswith(".SpikingConvBlock")}
    assert "aten.conv2d.default" in in_blocks
    assert not [t for t in in_blocks if t.startswith(("aten.ge.", "aten.cat.", "aten.stack."))]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_operator_launches_its_kernel_once(case, cuda_device):
    name = case.split("+")[0]
    counts = K.launch_counts if name in K.KERNELS else KL.launch_counts
    args = _args(case, torch.bfloat16, cuda_device)
    before = dict(counts)
    got = _op(case)(*args)
    torch.cuda.synchronize()
    assert counts[name] == before[name] + 1
    assert sum(counts.values()) == sum(before.values()) + 1
    wrapper = getattr(K if name in K.KERNELS else KL, name)
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    p = LIFParams(*args[len(tensors):len(tensors) + 4])
    if name.startswith("affine_lif_fwd"):
        want = wrapper(*tensors[:3], p, tensors[3], *args[len(tensors) + 4:])
    elif name.startswith("lif_scan_fwd"):
        want = wrapper(tensors[0], p, tensors[1])
    else:
        want = wrapper(*tensors, p)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(g, w)
