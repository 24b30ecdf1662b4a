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

Tensor parallelism (inference only, parallel/mesh.py): under
``tensor_parallel(mesh)`` the parameters are the rank's output-channel
shards, so every activation holds 1/k of its channels. A conv whose input
holds a shard all-gathers it in global channel order first
(:func:`conv2d_nhwc`; a concat gathers each part); GroupNorm keeps the
global group count, local when the rank holds whole groups and with its
per-channel sums gathered otherwise; everything per channel (the LIF, the
affine, SiLU, the bias, the skip resize) runs on the shard.

Spatial parallelism (training and evaluation, parallel/mesh.py part (d)):
under ``spatial_parallel(mesh, height)`` every map holds this rank's rows
``row_partition(n)`` of its n global rows, and each layer is told the
global rows of its input (``rows=``): nothing is inferred from a local
shape. A conv computes its SAME pads from the global height and fetches
the input rows its output rows read, halo and zero rows included
(:func:`conv2d_nhwc`); GroupNorm sums its statistics over the spatial
group; the transposed conv and the skip resize fetch their source rows in
global coordinates (:class:`UpBlock`). The normalize+LIF stage is per
pixel and runs on the local rows as it is.
"""

from __future__ import annotations

import math
import threading

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import (
    all_gather_channels,
    current_spatial_group,
    current_tensor_group,
    fetch_rows,
    full_channels,
    spatial_sum,
)
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


def out_rows(rows: int | None, stride: int) -> int | None:
    """Global rows of a SAME conv's output at ``stride`` (None passes)."""
    return None if rows is None else -(-rows // stride)


def _global_rows(rows: int | None, what: str) -> int:
    if rows is None:
        raise ValueError(f"{what} under spatial parallelism needs its input's global row count "
                         "(rows=)")
    return int(rows)


def _empty_rows(x: torch.Tensor, shape) -> torch.Tensor:
    """Zero rows of ``shape`` that still hang on ``x`` in the autograd
    graph: a rank that owns no row of a map runs the same exchanges, in
    the same order, in its backward as the others."""
    return x.new_zeros(shape) + x.sum() * 0


def _conv_input_rows(x: torch.Tensor, rows: int, k: int, stride: int, sg) -> torch.Tensor:
    """The input rows (halo and zero pad rows included) that this rank's
    output rows of a SAME conv read, the pads taken from the global
    height."""
    n_out, pad = -(-rows // stride), same_pads(rows, k, stride)[0]
    lo, hi = [], []
    for r in range(sg.size):
        a, b = sg.part(n_out, r)
        lo.append(a * stride - pad if b > a else 0)
        hi.append((b - 1) * stride - pad + k if b > a else 0)
    return fetch_rows(x, rows, lo, hi)


def conv2d_nhwc(
    x: torch.Tensor,
    weight: torch.Tensor,
    stride: int = 1,
    f32_result: bool = False,
    name: str | None = None,
    rows: int | None = None,
) -> torch.Tensor:
    """SAME-padded 2D conv of an NHWC tensor with an OIHW kernel, computed
    in x's dtype; returns an NHWC-contiguous tensor. With ``f32_result``
    the kernel is rounded to x's dtype and the conv runs on the fp32
    values of both operands, returning fp32: "bf16 operands, f32
    result", what the jitted JAX package computes where a bf16 conv feeds
    an fp32 consumer. Each product of two bf16 values is exact in fp32 (and
    in TF32), so only the summation order differs from a bf16 conv that
    accumulates in fp32. ``name`` marks the convolution for
    :func:`conv_name` while it is dispatched. An input holding a channel
    shard under tensor parallelism is gathered first
    (parallel/mesh.py::full_channels). Under spatial parallelism ``rows``
    is the input's global row count: the rows the local output rows read
    are fetched first, and the conv pads only the width."""
    x = full_channels(x, weight.shape[1])
    kh, kw = weight.shape[-2:]
    sg = current_spatial_group()
    if sg is not None:
        if kh > 1 or stride > 1:
            x = _conv_input_rows(x, _global_rows(rows, "a conv"), kh, stride, sg)
        if x.shape[1] == 0:
            dtype = torch.float32 if f32_result else x.dtype
            return _empty_rows(x, (x.shape[0], 0, -(-x.shape[2] // stride),
                                   weight.shape[0])).to(dtype)
        ph = (0, 0)
    else:
        ph = same_pads(x.shape[1], kh, stride)
    pw = same_pads(x.shape[2], kw, stride)
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


def shard_groups(features: int, channels: int) -> int | None:
    """The GroupNorm groups of a ``features``-wide layer that a tensor of
    ``channels`` of its channels holds whole: ``_num_groups(features)``
    for the full width, its 1/k share on a shard of k whole groups, None
    when a group straddles the shards (the statistics then need the other
    ranks' sums)."""
    groups = _num_groups(features)
    k = features // channels
    return groups // k if groups % k == 0 else None


def gathered_group_moments(s1: torch.Tensor, s2: torch.Tensor, features: int,
                           count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, mean of squares) of the groups a channel shard's
    channels belong to, when groups straddle the shards: the shard's
    per-channel sums ``s1`` / ``s2`` (N, c) are all-gathered over the tensor
    group, folded into the global groups of ``count`` elements each and
    read back at this rank's channels."""
    tg = current_tensor_group()
    sums = all_gather_channels(torch.stack([s1, s2]), tg)  # (2, N, features)
    groups = _num_groups(features)
    g = sums.view(2, s1.shape[0], groups, features // groups).sum(3) / count
    per_channel = g.repeat_interleave(features // groups, 2)
    c = s1.shape[1]
    mine = per_channel[..., tg.rank * c : (tg.rank + 1) * c]
    return mine[0], mine[1]


def spatial_group_moments(s1: torch.Tensor, s2: torch.Tensor, groups: int,
                          count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-group (mean, mean of squares), (N, groups), of a row-sharded
    map from this rank's per-channel sums ``s1`` / ``s2`` (N, C): the sums
    are added over the spatial group in one all-reduce, then folded into
    groups of ``count`` elements each (the same order of reductions as one
    process: pixels first, then the channels of a group)."""
    sums = spatial_sum(torch.stack([s1, s2]))
    g = sums.view(2, s1.shape[0], groups, s1.shape[1] // groups).sum(3) / count
    return g[0], g[1]


def group_norm_nhwc(
    x: torch.Tensor, groups: int, scale: torch.Tensor, bias: torch.Tensor,
    stats: torch.Tensor, features: int | None = None, rows: int | None = None,
) -> torch.Tensor:
    """flax ``nn.GroupNorm`` (eps 1e-6, one-pass variance) in fp32 on a
    (B, H, W, C) tensor. The group mean and variance come from ``stats``,
    a tensor of x's shape (``x`` itself, or its rounding to the compute
    dtype). Under tensor parallelism ``x`` may be a channel shard of a
    ``features``-wide layer of ``groups`` groups (:func:`shard_groups`);
    under spatial parallelism it holds this rank's rows of ``rows`` global
    rows, and the statistics are summed over the spatial group."""
    n, h, w, c = x.shape
    if current_spatial_group() is not None:
        sf = stats.float()
        mean, mean2 = spatial_group_moments(sf.sum((1, 2)), sf.square().sum((1, 2)), groups,
                                            _global_rows(rows, "GroupNorm") * w * (c // groups))
        var = (mean2 - mean.square()).clamp(min=0.0)
        mul = (torch.rsqrt(var + GN_EPS).repeat_interleave(c // groups, 1) * scale)
        mean_c = mean.repeat_interleave(c // groups, 1)
        return (x.float() - mean_c[:, None, None]) * mul[:, None, None] + bias
    features = features or c
    if c != features:
        local = shard_groups(features, c)
        if local is None:
            sf = stats.float()
            cg = features // groups
            mean_c, mean2_c = gathered_group_moments(
                sf.sum((1, 2)), sf.square().sum((1, 2)), features, h * w * cg)
            var = (mean2_c - mean_c.square()).clamp(min=0.0)
            mul = torch.rsqrt(var + GN_EPS) * scale
            y = (x.float() - mean_c[:, None, None]) * mul[:, None, None] + bias
            return y
        groups = local
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
                with_readouts: bool = False, rows: int | None = None):
        """``rows``: the global rows of ``x_t`` under spatial parallelism
        (the output has ``out_rows(rows, stride)``)."""
        t, b = x_t.shape[:2]
        x = x_t.reshape((t * b,) + tuple(x_t.shape[2:])).to(self.dtype)
        # bf16: the group statistics read the conv's fp32 result, the LIF
        # stage its bf16 rounding (the jitted JAX block's optimized HLO)
        xf = conv2d_nhwc(x, self.weight, self.stride, f32_result=True, name=CONV_OUT, rows=rows)
        x = xf.to(self.dtype)
        c = xf.shape[-1]  # the layer's width, or 1/k of it under tensor parallelism
        groups = shard_groups(self.features, c)
        cg = self.features // _num_groups(self.features)
        n = x.shape[1] * x.shape[2] * cg
        if current_spatial_group() is not None:  # rows sharded: sums over the group
            mean, mean2 = spatial_group_moments(
                xf.sum((1, 2)), xf.square().sum((1, 2)), groups,
                out_rows(rows, self.stride) * x.shape[2] * cg)
            var = (mean2 - mean.square()).clamp(min=0.0)
            mean_c = mean.repeat_interleave(cg, 1).view(t, b, c)
            rstd_c = torch.rsqrt(var + GN_EPS).repeat_interleave(cg, 1).view(t, b, c)
        elif groups is None:  # groups straddle the tensor-parallel shards
            mean_c, mean2_c = gathered_group_moments(
                xf.sum((1, 2)), xf.square().sum((1, 2)), self.features, n)
            var = (mean2_c - mean_c.square()).clamp(min=0.0)
            mean_c, rstd_c = mean_c.view(t, b, c), torch.rsqrt(var + GN_EPS).view(t, b, c)
        else:
            # Reduce over (H, W) first, then fold channels into groups on
            # the tiny (T*B, C) sums — same op order as the JAX block.
            s1 = xf.sum((1, 2)).view(t * b, groups, cg).sum(2)
            s2 = xf.square().sum((1, 2)).view(t * b, groups, cg).sum(2)
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

    def forward(self, x_t: torch.Tensor, state: dict | None = None, rows: int | None = None):
        state = state or {}
        s1, v1 = self.conv1(x_t, state.get("conv1"), rows=rows)
        s2, v2 = self.conv2(s1, state.get("conv2"), rows=out_rows(rows, 2))
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

    def forward(self, x: torch.Tensor, rows: int | None = None) -> torch.Tensor:
        # bf16: GroupNorm normalizes the conv's fp32 result with statistics
        # of its bf16 rounding (the jitted JAX block's optimized HLO)
        y = conv2d_nhwc(x.to(self.dtype), self.weight, self.stride, f32_result=True,
                        name=CONV_OUT, rows=rows)
        x = group_norm_nhwc(y, _num_groups(self.features), self.gn_scale, self.gn_bias,
                            stats=y.to(self.dtype), features=self.features,
                            rows=out_rows(rows, self.stride))
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
        self.skip_ch, self.up_ch = skip_ch, up_ch
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

    def forward(self, x: torch.Tensor, skip: torch.Tensor, rows: int | None = None,
                skip_rows: int | None = None) -> torch.Tensor:
        """``rows`` / ``skip_rows``: the global rows of ``x`` and ``skip``
        under spatial parallelism (the output has ``2 * rows``)."""
        x = full_channels(x, self.up_weight.shape[0])
        sg = current_spatial_group()
        if sg is not None:
            rows, skip_rows = _global_rows(rows, "UpBlock"), _global_rows(skip_rows, "UpBlock")
            up = self._up_rows(x, rows, sg)
            if (2 * rows, up.shape[2]) != (skip_rows, skip.shape[2]):
                skip = _resize_rows(skip, skip_rows, 2 * rows, up.shape[2], sg)
        else:
            up = self._up(x)
            if tuple(up.shape[1:3]) != tuple(skip.shape[1:3]):
                skip = F.interpolate(
                    skip.permute(0, 3, 1, 2), size=tuple(up.shape[1:3]),
                    mode="bilinear", align_corners=False,
                ).permute(0, 2, 3, 1)
        # the skip resize is per channel, so it ran on the shard
        x = torch.cat([full_channels(skip.to(self.dtype), self.skip_ch),
                       full_channels(up, self.up_ch)], -1)
        n = None if rows is None else 2 * rows
        return self.conv2(self.conv1(x, rows=n), rows=n)

    def _up(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(
            x.to(self.dtype).permute(0, 3, 1, 2),
            self.up_weight.to(dtype=self.dtype, memory_format=torch.channels_last),
            None,
            stride=2,
        ).permute(0, 2, 3, 1) + self.up_bias.to(self.dtype)  # bias after rounding, as Conv1x1

    def _up_rows(self, x: torch.Tensor, rows: int, sg) -> torch.Tensor:
        """This rank's rows of the 2x transposed conv's ``2 * rows`` global
        output rows: output row i reads input row i // 2 alone, so the
        input rows are fetched (no halo when the partitions nest) and the
        output cropped to the local rows."""
        parts = [sg.part(2 * rows, r) for r in range(sg.size)]
        lo = [a // 2 if b > a else 0 for a, b in parts]
        hi = [(b - 1) // 2 + 1 if b > a else 0 for a, b in parts]
        src = fetch_rows(x, rows, lo, hi)
        a, b = parts[sg.rank]
        if b <= a:
            return _empty_rows(src, (src.shape[0], 0, 2 * src.shape[2], self.up_ch)).to(self.dtype)
        up = self._up(src)
        return up[:, a - 2 * lo[sg.rank]: b - 2 * lo[sg.rank]]


def _source_rows(n_in: int, n_out: int, lo: int, hi: int):
    """PyTorch's bilinear source index of output rows ``[lo, hi)`` of a
    resize from ``n_in`` to ``n_out`` rows (half-pixel centres,
    ``align_corners=False``, in fp32 as ``upsample_bilinear2d`` computes
    it): the first source rows, their next rows and the weights of the
    next rows."""
    scale = torch.tensor(float(n_in), dtype=torch.float32) / n_out
    src = ((torch.arange(lo, hi, dtype=torch.float32) + 0.5) * scale - 0.5).clamp(min=0.0)
    i0 = src.to(torch.int64)
    i1 = torch.where(i0 < n_in - 1, i0 + 1, i0)
    return i0, i1, src - i0.to(torch.float32)


def _lerp_axis(x: torch.Tensor, dim: int, i0, i1, w1) -> torch.Tensor:
    """Rows ``i0`` and ``i1`` of fp32 ``x`` along ``dim``, mixed with
    weights ``1 - w1`` and ``w1``."""
    shape = [1] * x.ndim
    shape[dim] = -1
    w1 = w1.to(x.device).view(shape)
    return (x.index_select(dim, i0.to(x.device)) * (1.0 - w1)
            + x.index_select(dim, i1.to(x.device)) * w1)


def _resize_rows(skip: torch.Tensor, n_in: int, n_out: int, w_out: int, sg) -> torch.Tensor:
    """This rank's rows of the bilinear resize of a row-sharded ``skip``
    (``n_in`` global rows) to ``n_out`` x ``w_out``: the source rows of the
    local output rows, taken in global coordinates, are fetched and mixed
    (then the width, which is whole on every rank), in fp32, rounded once
    to skip's dtype."""
    lo, hi = [], []
    for r in range(sg.size):
        a, b = sg.part(n_out, r)
        i0, i1, _ = _source_rows(n_in, n_out, a, b)
        lo.append(int(i0.min()) if b > a else 0)
        hi.append(int(i1.max()) + 1 if b > a else 0)
    src = fetch_rows(skip, n_in, lo, hi).float()
    a, b = sg.part(n_out)
    i0, i1, w1 = _source_rows(n_in, n_out, a, b)
    y = _lerp_axis(src, 1, i0 - lo[sg.rank], i1 - lo[sg.rank], w1)
    if w_out != skip.shape[2]:
        y = _lerp_axis(y, 2, *_source_rows(skip.shape[2], w_out, 0, w_out))
    return y.to(skip.dtype)
