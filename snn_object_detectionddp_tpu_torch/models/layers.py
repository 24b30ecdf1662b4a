"""Building-block layers for the spiking temporal detector.

Layout is channels-last throughout: (B, H, W, C) tensors, time-major
(T, B, H, W, C) sequences, folded to (T*B, H, W, C) for every conv. A conv
permutes to the NCHW view (which is channels-last in memory, no copy),
runs with channels-last weights and permutes back, so activations stay
NHWC-contiguous and the LIF kernel reads channels innermost.

Parity with the JAX (flax) package, which these modules are held against:
- ``padding="SAME"`` pads (0, 1) on an even side at stride 2 and (1, 1) on
  an odd one; asymmetric cases go through ``F.pad`` (:func:`conv2d_nhwc`).
- GroupNorm uses eps 1e-6 and the one-pass variance E[x²]-E[x]².
- Convs in spiking blocks and ``ConvBlock`` have no bias.
- flax ``ConvTranspose`` (no kernel flip) equals ``conv_transpose2d`` with
  the spatially flipped kernel; the converter stores it flipped, as
  ``(in, out, kh, kw)``.
- The skip resize is bilinear with half-pixel centers
  (``align_corners=False``), equal to ``jax.image.resize`` when upsampling.

Modules are built on the ``meta`` device; parameters live in a plain
dict (see models/detector.py) and each module fills its own with
``init_param`` following the flax initializers.
"""

from __future__ import annotations

import math
import threading

import torch
import torch.nn.functional as F
from torch import nn

from .lif import LIFParams, run_affine_lif_tb

GN_EPS = 1e-6
# The name of the convs whose outputs train/step.py's remat_policy
# "save_conv" keeps (the JAX package's checkpoint_name(..., "conv_out")):
# the spiking blocks', the ConvBlocks' and the ConvLSTM's input half.
CONV_OUT = "conv_out"
_conv_name = threading.local()
# flax truncated-normal initializers rescale by the std of a unit normal
# truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def _num_groups(channels: int) -> int:
    """Largest group count <= 32 that divides ``channels``."""
    for g in (32, 16, 8, 4, 2, 1):
        if channels % g == 0:
            return g
    return 1


def _fan_in(weight: torch.Tensor) -> int:
    """fan-in of an OIHW conv kernel."""
    return weight.shape[1] * weight.shape[2] * weight.shape[3]


def trunc_normal_init(t: torch.Tensor, fan_in: int, scale: float, g: torch.Generator) -> None:
    """flax variance_scaling(scale, "fan_in", "truncated_normal"):
    he_normal is scale 2, lecun_normal scale 1."""
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA ``padding="SAME"`` (low, high) padding of one side."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_name() -> str | None:
    """The ``name`` of the :func:`conv2d_nhwc` call whose convolution this
    thread is dispatching, None outside one: what a selective-checkpoint
    policy reads at dispatch."""
    return getattr(_conv_name, "value", None)


def conv2d_nhwc(
    x: torch.Tensor,
    weight: torch.Tensor,
    stride: int = 1,
    f32_result: bool = False,
    name: str | None = None,
) -> torch.Tensor:
    """SAME-padded 2D conv of an NHWC tensor with an OIHW kernel, computed
    in x's dtype; returns an NHWC-contiguous tensor. With ``f32_result``
    the kernel is rounded to x's dtype and the conv runs on the fp32
    values of both operands, returning fp32: "bf16 operands, f32
    result", what the jitted JAX package computes where a bf16 conv feeds
    an fp32 consumer. Each product of two bf16 values is exact in fp32 (and
    in TF32), so only the summation order differs from a bf16 conv that
    accumulates in fp32. ``name`` marks the convolution for
    :func:`conv_name` while it is dispatched."""
    kh, kw = weight.shape[-2:]
    ph, pw = same_pads(x.shape[1], kh, stride), same_pads(x.shape[2], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        padding = (ph[0], pw[0])
    else:
        x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
        padding = (0, 0)
    w = weight.to(dtype=x.dtype, memory_format=torch.channels_last)
    if f32_result:
        x, w = x.float(), w.float()
    _conv_name.value = name
    try:
        y = F.conv2d(x.permute(0, 3, 1, 2), w, None, stride, padding)
    finally:
        _conv_name.value = None
    return y.permute(0, 2, 3, 1).contiguous()


def group_norm_nhwc(
    x: torch.Tensor, groups: int, scale: torch.Tensor, bias: torch.Tensor,
    stats: torch.Tensor,
) -> torch.Tensor:
    """flax ``nn.GroupNorm`` (eps 1e-6, one-pass variance) in fp32 on a
    (B, H, W, C) tensor. The group mean and variance come from ``stats``,
    a tensor of x's shape (``x`` itself, or its rounding to the compute
    dtype)."""
    n, h, w, c = x.shape
    xg = x.float().reshape(n, h * w, groups, c // groups)
    sg = stats.float().reshape(n, h * w, groups, c // groups)
    mean = sg.mean((1, 3), keepdim=True)
    mean2 = sg.square().mean((1, 3), keepdim=True)
    var = (mean2 - mean.square()).clamp(min=0.0)
    mul = torch.rsqrt(var + GN_EPS) * scale.view(1, 1, groups, c // groups)
    y = (xg - mean) * mul + bias.view(1, 1, groups, c // groups)
    return y.reshape(n, h, w, c)


def membrane_readout(
    spikes_t: torch.Tensor, v_final: torch.Tensor, p: LIFParams
) -> torch.Tensor:
    """Continuous readout of a spiking block: last-step pre-reset membrane
    (``v_final + s_T * threshold``)."""
    return v_final + spikes_t[-1] * p.threshold


class SpikingConvBlock(nn.Module):
    """Conv -> GroupNorm -> LIF over a (T, B, H, W, C) time-major tensor.

    GroupNorm is split: the group statistics are plain tensor ops, the
    normalize pass is a per-(t, b, c) affine fused into the LIF stage
    (models/lif.py::run_affine_lif_tb). Returns (spikes (T, B, H', W', C)
    in the compute dtype, v_final (B, H', W', C) fp32) and, with
    ``with_readouts``, the per-step readouts (T*B, H', W', C).
    """

    def __init__(self, in_ch: int, features: int, lif: LIFParams,
                 stride: int = 1, kernel: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.features, self.lif, self.stride, self.dtype = features, lif, stride, dtype
        self.weight = nn.Parameter(torch.empty(features, in_ch, kernel, kernel))
        self.gn_scale = nn.Parameter(torch.empty(features))
        self.gn_bias = nn.Parameter(torch.empty(features))

    def init_param(self, name: str, t: torch.Tensor, g: torch.Generator) -> None:
        if name == "weight":
            trunc_normal_init(t, _fan_in(t), 2.0, g)  # he_normal
        elif name == "gn_scale":
            t.fill_(1.0)
        else:
            t.zero_()

    def forward(self, x_t: torch.Tensor, v0: torch.Tensor | None = None,
                with_readouts: bool = False):
        t, b = x_t.shape[:2]
        x = x_t.reshape((t * b,) + tuple(x_t.shape[2:])).to(self.dtype)
        # bf16: the group statistics read the conv's fp32 result, the LIF
        # stage its bf16 rounding (the jitted JAX block's optimized HLO)
        xf = conv2d_nhwc(x, self.weight, self.stride, f32_result=True, name=CONV_OUT)
        x = xf.to(self.dtype)
        c = self.features
        groups = _num_groups(c)
        cg = c // groups
        # Reduce over (H, W) first, then fold channels into groups on the
        # tiny (T*B, C) sums — same op order as the JAX block.
        s1 = xf.sum((1, 2)).view(t * b, groups, cg).sum(2)
        s2 = xf.square().sum((1, 2)).view(t * b, groups, cg).sum(2)
        n = x.shape[1] * x.shape[2] * cg
        mean = s1 / n
        mean2 = s2 / n
        var = (mean2 - mean.square()).clamp(min=0.0)
        rstd = torch.rsqrt(var + GN_EPS)
        mean_c = mean.repeat_interleave(cg, 1).view(t, b, c)
        rstd_c = rstd.repeat_interleave(cg, 1).view(t, b, c)
        a = rstd_c * self.gn_scale
        bias = self.gn_bias - mean_c * rstd_c * self.gn_scale
        out = run_affine_lif_tb(x, a, bias, self.lif, v0, with_readouts)
        spikes = out[0].view((t, b) + tuple(out[0].shape[1:]))
        return (spikes,) + tuple(out[1:])


class SpikingDownBlock(nn.Module):
    """Stride-2 spiking block + stride-1 spiking block (2x downsample).
    State is a dict {'conv1': v, 'conv2': v}."""

    def __init__(self, in_ch: int, features: int, lif: LIFParams,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = SpikingConvBlock(in_ch, features, lif, stride=2, dtype=dtype)
        self.conv2 = SpikingConvBlock(features, features, lif, stride=1, dtype=dtype)

    def forward(self, x_t: torch.Tensor, state: dict | None = None):
        state = state or {}
        s1, v1 = self.conv1(x_t, state.get("conv1"))
        s2, v2 = self.conv2(s1, state.get("conv2"))
        return s2, {"conv1": v1, "conv2": v2}


class ConvBlock(nn.Module):
    """Non-spiking Conv -> GroupNorm -> SiLU on a (B, H, W, C) tensor."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 kernel: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.features, self.stride, self.dtype = features, stride, dtype
        self.weight = nn.Parameter(torch.empty(features, in_ch, kernel, kernel))
        self.gn_scale = nn.Parameter(torch.empty(features))
        self.gn_bias = nn.Parameter(torch.empty(features))

    init_param = SpikingConvBlock.init_param

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # bf16: GroupNorm normalizes the conv's fp32 result with statistics
        # of its bf16 rounding (the jitted JAX block's optimized HLO)
        y = conv2d_nhwc(x.to(self.dtype), self.weight, self.stride, f32_result=True,
                        name=CONV_OUT)
        x = group_norm_nhwc(y, _num_groups(self.features), self.gn_scale, self.gn_bias,
                            stats=y.to(self.dtype))
        return F.silu(x).to(self.dtype)


class Conv1x1(nn.Module):
    """1x1 conv with bias (flax ``nn.Conv(features, (1, 1))``); the bias
    init is a constant given by the owner (head priors, zeros elsewhere)."""

    def __init__(self, in_ch: int, features: int, bias_init: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype, self.bias_init = dtype, bias_init
        self.weight = nn.Parameter(torch.empty(features, in_ch, 1, 1))
        self.bias = nn.Parameter(torch.empty(features))

    def init_param(self, name: str, t: torch.Tensor, g: torch.Generator) -> None:
        if name == "weight":
            trunc_normal_init(t, _fan_in(t), 1.0, g)  # lecun_normal
        else:
            t.fill_(self.bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # The bias is added to the conv's rounded result, in the compute
        # dtype, as flax does and as the jitted JAX package keeps it.
        return conv2d_nhwc(x.to(self.dtype), self.weight, 1) + self.bias.to(self.dtype)


class UpBlock(nn.Module):
    """2x transposed-conv upsample, bilinear skip resize on a size
    mismatch, concat [skip, up], two ConvBlocks."""

    def __init__(self, in_ch: int, skip_ch: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        up_ch = in_ch // 2
        # (in, out, kh, kw), spatially flipped relative to flax's HWIO kernel.
        self.up_weight = nn.Parameter(torch.empty(in_ch, up_ch, 2, 2))
        self.up_bias = nn.Parameter(torch.empty(up_ch))
        self.conv1 = ConvBlock(skip_ch + up_ch, features, dtype=dtype)
        self.conv2 = ConvBlock(features, features, dtype=dtype)

    def init_param(self, name: str, t: torch.Tensor, g: torch.Generator) -> None:
        if name == "up_weight":
            # flax ConvTranspose default: lecun_normal, fan-in = kh*kw*in.
            trunc_normal_init(t, t.shape[0] * t.shape[2] * t.shape[3], 1.0, g)
        else:
            t.zero_()

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = F.conv_transpose2d(
            x.to(self.dtype).permute(0, 3, 1, 2),
            self.up_weight.to(dtype=self.dtype, memory_format=torch.channels_last),
            None,
            stride=2,
        ).permute(0, 2, 3, 1) + self.up_bias.to(self.dtype)  # bias after rounding, as Conv1x1
        if tuple(up.shape[1:3]) != tuple(skip.shape[1:3]):
            skip = F.interpolate(
                skip.permute(0, 3, 1, 2), size=tuple(up.shape[1:3]),
                mode="bilinear", align_corners=False,
            ).permute(0, 2, 3, 1)
        x = torch.cat([skip.to(self.dtype), up], -1)
        return self.conv2(self.conv1(x))
