"""Plain float32 PyTorch reference of the spiking temporal detector.

A frozen copy of what the program computes, written from its published
description and kept with the benchmark: the s2d4 spiking backbone, the
temporal U-Net with a ConvLSTM or a 2-layer token-LSTM bottleneck, and the
anchor-free DFL head. It imports nothing of the program. Parameters are a
flat ``{name: tensor}`` dict whose names and shapes :func:`param_spec`
gives; the benchmark makes the values from its seed and hands the same
dict to the program and to this reference.

Everything runs in float32 with TF32 off (the caller sets the switches,
:func:`strict_fp32`). ``Numerics`` rounds the operands of every conv and
matrix product: identity for the reference, a per-tensor-scaled fp8
(e4m3) rounding for the lower-precision control.

Layout: activations are NCHW here; sequences are (T, B, C, H, W).
Conventions the program shares:
- SAME padding as XLA: (0, 1) on an even side at stride 2.
- GroupNorm: the largest group count <= 32 dividing C, eps 1e-6, one-pass
  variance E[x^2] - E[x]^2 clamped at 0.
- LIF (soft reset): v' = decay * v + I; s = H(v' - thr); v = v' - s * thr,
  with the SuperSpike surrogate 1 / (slope * |v' - thr| + 1)^2 as dH.
- A spiking block's continuous readout is v_final + s_T * thr.
- space-to-depth channel order (row in block, column in block, channel).
- The transposed conv's kernel is stored (in, out, kh, kw) and applied as
  ``conv_transpose2d``; the skip is resized bilinearly (half-pixel
  centres) when its size differs from the upsampled map.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

GN_EPS = 1e-6
STRIDES = (8, 16, 32)
# (stem, p3, p4, p5) widths and extra blocks a stage, by backbone preset.
PRESETS = {
    "yolo11n.pt": ((32, 64, 128, 256), 0),
    "yolo11s.pt": ((32, 96, 192, 384), 0),
    "yolo11m.pt": ((48, 128, 256, 512), 1),
    "yolo11l.pt": ((64, 160, 320, 640), 2),
}


@dataclass(frozen=True)
class ModelShape:
    """The sizes the reference is built from (a configuration file's
    ``model`` section)."""

    num_classes: int = 8
    reg_max: int = 16
    preset: str = "yolo11m.pt"
    width_mult: float = 1.0
    bottleneck: str = "convlstm"  # "convlstm" | "lstm"
    image_size: tuple = (480, 640)
    threshold: float = 1.0
    decay: float = 0.05
    surrogate_slope: float = 4.0

    @classmethod
    def from_config(cls, model: dict) -> "ModelShape":
        spike = model.get("spike", {})
        return cls(num_classes=model["num_classes"], reg_max=model["hyp"]["reg_max"],
                   preset=model["yolo_model_name"], width_mult=model["width_mult"],
                   bottleneck=model["bottleneck"], image_size=tuple(model["image_size"]),
                   threshold=spike.get("threshold", 1.0), decay=spike.get("decay", 0.05),
                   surrogate_slope=spike.get("surrogate_slope", 4.0))

    def channels(self):
        chans, depth = PRESETS[self.preset]
        return tuple(max(16, int(round(c * self.width_mult / 16)) * 16) for c in chans), depth


@contextlib.contextmanager
def strict_fp32():
    """TF32 off for cuDNN and CUDA matmuls inside the block."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class Numerics:
    """How the operands of a conv or a matrix product are rounded:
    ``"f32"`` leaves them, ``"fp8"`` rounds each tensor to float8 e4m3
    after scaling its largest magnitude to 448 (and back), the
    straight-through way: the gradient passes the rounding unchanged."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision must be 'f32' or 'fp8', got {precision!r}")
        self.precision = precision

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "f32":
            return x
        with torch.no_grad():
            scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
            q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (q - x).detach()


F32 = Numerics("f32")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _num_groups(c: int) -> int:
    for g in (32, 16, 8, 4, 2, 1):
        if c % g == 0:
            return g
    return 1


def param_spec(shape: ModelShape) -> list[tuple[str, tuple, str, float]]:
    """Every parameter as (name, shape, init, value): ``init`` is
    ``"normal"`` (std ``value``), ``"const"`` (filled with ``value``) or
    ``"forget"`` (zeros with ``value`` on the forget-gate quarter). The
    normal stds follow the program's initialisers by variance: He for
    spiking blocks and ConvBlocks, LeCun for 1x1 and transposed convs,
    Glorot for the gate kernels, 1/sqrt(n) for recurrent matrices."""
    (c_stem, c_p3, c_p4, c_p5), depth = shape.channels()
    spec: list = []

    def conv(name, cin, cout, k=3, gain=2.0):
        spec.append((f"{name}.weight", (cout, cin, k, k), "normal",
                     math.sqrt(gain / (cin * k * k))))

    def gn(name, c):
        spec.append((f"{name}.gn_scale", (c,), "const", 1.0))
        spec.append((f"{name}.gn_bias", (c,), "const", 0.0))

    def block(name, cin, cout):  # spiking block or ConvBlock
        conv(name, cin, cout)
        gn(name, cout)

    def conv1x1(name, cin, cout, bias):
        conv(name, cin, cout, k=1, gain=1.0)
        spec.append((f"{name}.bias", (cout,), "const", bias))

    block("backbone.stem1", 3 * 16, c_stem)
    block("backbone.stem2", c_stem, 2 * c_stem)
    prev = 2 * c_stem
    for i, c in enumerate((c_p3, c_p4, c_p5)):
        block(f"backbone.stage{i + 1}.conv1", prev, c)
        block(f"backbone.stage{i + 1}.conv2", c, c)
        for d in range(depth):
            block(f"backbone.stage{i + 1}_block{d}", c, c)
        prev = c
    base = int(shape.width_mult * 128)
    c1, c2, c3, c4 = base, 2 * base, 4 * base, 8 * base
    block("unet.enc1", c_p3, c1)
    block("unet.down1.conv1", c1, c2)
    block("unet.down1.conv2", c2, c2)
    block("unet.enc2", c2 + c_p4, c2)
    block("unet.down2.conv1", c2, c3)
    block("unet.down2.conv2", c3, c3)
    block("unet.enc3", c3 + c_p5, c3)
    block("unet.down3.conv1", c3, c4)
    block("unet.down3.conv2", c4, c4)
    if shape.bottleneck == "convlstm":
        spec.append(("unet.bottleneck.gates_kernel", (4 * c4, 2 * c4, 3, 3), "normal",
                     math.sqrt(2.0 / (9 * 2 * c4 + 9 * 4 * c4))))
        spec.append(("unet.bottleneck.gates_bias", (4 * c4,), "forget", 1.0))
    elif shape.bottleneck == "lstm":
        for n in range(2):
            spec.append((f"unet.bottleneck.l{n}_w_ih", (c4, 4 * c4), "normal",
                         math.sqrt(2.0 / (c4 + 4 * c4))))
            spec.append((f"unet.bottleneck.l{n}_w_hh", (c4, 4 * c4), "normal",
                         math.sqrt(1.0 / (4 * c4))))
            spec.append((f"unet.bottleneck.l{n}_bias", (4 * c4,), "forget", 1.0))
    else:
        raise ValueError(f"unknown bottleneck {shape.bottleneck!r}")
    block("unet.bottleneck_conv", c4, c4)
    for name, cin, cskip, cout in (("up1", c4, c3, c3), ("up2", c3, c2, c2),
                                   ("up3", c2, c1, c1)):
        spec.append((f"unet.{name}.up_weight", (cin, cin // 2, 2, 2), "normal",
                     math.sqrt(1.0 / (cin * 4))))
        spec.append((f"unet.{name}.up_bias", (cin // 2,), "const", 0.0))
        block(f"unet.{name}.conv1", cskip + cin // 2, cout)
        block(f"unet.{name}.conv2", cout, cout)
    conv1x1("unet.out_p3", c1, c_p3, 0.0)
    conv1x1("unet.out_p4", c2, c_p4, 0.0)
    conv1x1("unet.out_p5", c3, c_p5, 0.0)
    nc, reg = shape.num_classes, shape.reg_max
    cb = max(64, 4 * reg)
    cc = max(c_p3, min(nc, 100), 128)
    for i, (ch, stride) in enumerate(zip((c_p3, c_p4, c_p5), STRIDES)):
        block(f"head.box{i}_conv1", ch, cb)
        block(f"head.box{i}_conv2", cb, cb)
        conv1x1(f"head.box{i}_out", cb, 4 * reg, 1.0)
        prior = math.log(5.0 / nc / (640.0 / stride) ** 2)
        block(f"head.cls{i}_conv1", ch, cc)
        block(f"head.cls{i}_conv2", cc, cc)
        conv1x1(f"head.cls{i}_out", cc, nc, prior)
    return spec


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _same(n: int, k: int, s: int) -> tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, num: Numerics, stride: int = 1) -> torch.Tensor:
    """SAME conv of an NCHW tensor."""
    ph = _same(x.shape[2], w.shape[2], stride)
    pw = _same(x.shape[3], w.shape[3], stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(num(x), num(w), None, stride)


def group_moments(x: torch.Tensor, groups: int):
    """Per-(sample, group) mean and variance of an NCHW tensor, broadcast
    back to (N, C, 1, 1)."""
    n, c = x.shape[:2]
    xg = x.reshape(n, groups, -1)
    mean = xg.mean(-1)
    var = (xg.square().mean(-1) - mean.square()).clamp(min=0.0)
    rep = c // groups
    return (mean.repeat_interleave(rep, 1)[:, :, None, None],
            var.repeat_interleave(rep, 1)[:, :, None, None])


class _Spike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shifted, slope):
        ctx.save_for_backward(shifted)
        ctx.slope = slope
        return (shifted >= 0).to(shifted.dtype)

    @staticmethod
    def backward(ctx, g):
        (shifted,) = ctx.saved_tensors
        return g / torch.square(ctx.slope * shifted.abs() + 1.0), None


def spiking_block(params, name, x_t, v0, shape: ModelShape, num: Numerics, stride=1):
    """Conv -> GroupNorm -> LIF over (T, B, C, H, W): (spikes, v_final)."""
    t, b = x_t.shape[:2]
    y = conv(x_t.reshape((t * b,) + tuple(x_t.shape[2:])), params[f"{name}.weight"], num,
             stride)
    mean, var = group_moments(y, _num_groups(y.shape[1]))
    cur = ((y - mean) * torch.rsqrt(var + GN_EPS) * params[f"{name}.gn_scale"][:, None, None]
           + params[f"{name}.gn_bias"][:, None, None])
    cur = cur.reshape((t, b) + tuple(cur.shape[1:]))
    v = torch.zeros_like(cur[0]) if v0 is None else v0
    spikes = []
    for step in range(t):
        v_pre = shape.decay * v + cur[step]
        s = _Spike.apply(v_pre - shape.threshold, shape.surrogate_slope)
        v = v_pre - s * shape.threshold
        spikes.append(s)
    return torch.stack(spikes), v


def conv_block(params, name, x, num: Numerics, stride=1):
    """Conv -> GroupNorm -> SiLU on (N, C, H, W)."""
    y = conv(x, params[f"{name}.weight"], num, stride)
    mean, var = group_moments(y, _num_groups(y.shape[1]))
    y = ((y - mean) * torch.rsqrt(var + GN_EPS) * params[f"{name}.gn_scale"][:, None, None]
         + params[f"{name}.gn_bias"][:, None, None])
    return F.silu(y)


def conv1x1(params, name, x, num: Numerics):
    return conv(x, params[f"{name}.weight"], num) + params[f"{name}.bias"][:, None, None]


def up_block(params, name, x, skip, num: Numerics):
    up = F.conv_transpose2d(num(x), num(params[f"{name}.up_weight"]), None, stride=2)
    up = up + params[f"{name}.up_bias"][:, None, None]
    if up.shape[2:] != skip.shape[2:]:
        skip = F.interpolate(skip, size=tuple(up.shape[2:]), mode="bilinear",
                             align_corners=False)
    x = torch.cat([skip, up], 1)
    return conv_block(params, f"{name}.conv2", conv_block(params, f"{name}.conv1", x, num), num)


def space_to_depth(x_t: torch.Tensor, block: int) -> torch.Tensor:
    """(T, B, C, H, W) -> (T, B, C*b*b, H/b, W/b), channel order (row in
    block, column in block, c)."""
    t, b, c, h, w = x_t.shape
    x = x_t.reshape(t, b, c, h // block, block, w // block, block)
    x = x.permute(0, 1, 4, 6, 2, 3, 5)  # (t, b, row, col, c, h', w')
    return x.reshape(t, b, block * block * c, h // block, w // block)


def convlstm(params, x_t, state, num: Numerics):
    """(T, B, C, H, W) -> (h_seq, (h, c)); gates (i, f, g, o) from one conv
    over [x; h]."""
    k, bias = params["unet.bottleneck.gates_kernel"], params["unet.bottleneck.gates_bias"]
    hidden = bias.shape[0] // 4
    t, b, _, hh, ww = x_t.shape
    if state is None:
        z = x_t.new_zeros((b, hidden, hh, ww))
        state = (z, z)
    h, c = state
    out = []
    for step in range(t):
        gates = conv(torch.cat([x_t[step], h], 1), k, num) + bias[:, None, None]
        i, f, g, o = gates.chunk(4, 1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out), (h, c)


def token_lstm(params, x_t, state, num: Numerics):
    """A 2-layer LSTM over the H*W tokens of each frame (row-major), the
    carry running from token to token and frame to frame: one
    ``torch.lstm`` over the T*H*W tokens. Gate order (i, f, g, o), one bias
    a layer. Returns (h_seq (T, B, C, H, W), (h, c) each (2, B, C))."""
    t, b, c, hh, ww = x_t.shape
    tokens = x_t.permute(0, 3, 4, 1, 2).reshape(t * hh * ww, b, c)
    weights = []
    for n in range(2):
        bias = params[f"unet.bottleneck.l{n}_bias"]
        weights += [num(params[f"unet.bottleneck.l{n}_w_ih"]).t().contiguous(),
                    num(params[f"unet.bottleneck.l{n}_w_hh"]).t().contiguous(), bias,
                    torch.zeros_like(bias)]
    if state is None:
        z = x_t.new_zeros((2, b, c))
        state = (z, z)
    hx = tuple(x.contiguous() for x in state)
    out, h, cc = torch.lstm(num(tokens).contiguous(), hx, weights, True, 2, 0.0,
                            torch.is_grad_enabled(), False, False)
    return out.reshape(t, hh, ww, b, c).permute(0, 3, 4, 1, 2), (h, cc)


# ---------------------------------------------------------------------------
# The detector
# ---------------------------------------------------------------------------


def _readout(spikes_t, v_final, shape: ModelShape):
    return v_final + spikes_t[-1] * shape.threshold


def head(params: dict, feats, num: Numerics = F32) -> list:
    """The head's three raw maps (B, h, w, 4*reg_max + nc), box logits
    first, from the U-Net's three refined maps (NCHW)."""
    maps = []
    for i, f in enumerate(feats):
        box = conv_block(params, f"head.box{i}_conv2",
                         conv_block(params, f"head.box{i}_conv1", f, num), num)
        box = conv1x1(params, f"head.box{i}_out", box, num)
        cls = conv_block(params, f"head.cls{i}_conv2",
                         conv_block(params, f"head.cls{i}_conv1", f, num), num)
        cls = conv1x1(params, f"head.cls{i}_out", cls, num)
        maps.append(torch.cat([box, cls], 1).permute(0, 2, 3, 1))
    return maps


def forward(params: dict, frames_t: torch.Tensor, state: dict | None, shape: ModelShape,
            num: Numerics = F32, tap=None):
    """(T, B, H, W, 3) frames in [0, 1] -> (three raw maps (B, h, w,
    4*reg_max + nc) of the last frame, new state). ``state`` holds every
    spiking block's membrane and the bottleneck's carry. ``tap(name,
    kind, args, out)``, when given, sees each layer's inputs and output as
    the layer check of layercheck.py takes them."""
    state = state or {}
    new: dict = {}
    _, depth = shape.channels()
    tap = tap or (lambda *a: None)
    x = space_to_depth(frames_t.permute(0, 1, 4, 2, 3).float(), 4)

    def sblock(name, x, stride=1):
        s, new[name] = spiking_block(params, name, x, state.get(name), shape, num, stride)
        tap(name, "spiking", (x, state.get(name)), (s, new[name]))
        return s

    def layer(name, kind, fn, *args):
        out = fn(params, name, *args, num)
        tap(name, kind, args, out)
        return out

    x = sblock("backbone.stem1", x)
    x = sblock("backbone.stem2", x)
    feats = []
    for i in range(3):
        x = sblock(f"backbone.stage{i + 1}.conv1", x, 2)
        x = sblock(f"backbone.stage{i + 1}.conv2", x)
        for d in range(depth):
            x = sblock(f"backbone.stage{i + 1}_block{d}", x)
        feats.append(x)
    p3, p4, p5 = feats
    x1 = sblock("unet.enc1", p3)
    d1 = sblock("unet.down1.conv2", sblock("unet.down1.conv1", x1, 2))
    x2 = sblock("unet.enc2", torch.cat([d1, p4], 2))
    d2 = sblock("unet.down2.conv2", sblock("unet.down2.conv1", x2, 2))
    x3 = sblock("unet.enc3", torch.cat([d2, p5], 2))
    d3 = sblock("unet.down3.conv2", sblock("unet.down3.conv1", x3, 2))
    carry = state.get("bottleneck")
    if shape.bottleneck == "convlstm":
        seq, new["bottleneck"] = convlstm(params, d3, carry, num)
    else:
        seq, new["bottleneck"] = token_lstm(params, d3, carry, num)
    tap("unet.bottleneck", shape.bottleneck, (d3, carry), seq)
    bott = layer("unet.bottleneck_conv", "conv_block", conv_block, seq[-1])
    skip3 = _readout(x3, new["unet.enc3"], shape)
    skip2 = _readout(x2, new["unet.enc2"], shape)
    skip1 = _readout(x1, new["unet.enc1"], shape)
    u1 = layer("unet.up1", "up", up_block, bott, skip3)
    u2 = layer("unet.up2", "up", up_block, u1, skip2)
    u3 = layer("unet.up3", "up", up_block, u2, skip1)
    refined = (layer("unet.out_p3", "conv1x1", conv1x1, u3),
               layer("unet.out_p4", "conv1x1", conv1x1, u2),
               layer("unet.out_p5", "conv1x1", conv1x1, u1))
    maps = head(params, refined, num)
    tap("head", "head", (refined,), maps)
    return maps, new


def preprocess(images_u8: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, 3) uint8 -> (T, B, H, W, 3) float32 in [0, 1]."""
    return images_u8.permute(1, 0, 2, 3, 4).float() * (1.0 / 255.0)
