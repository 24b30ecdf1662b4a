"""Optical-flow box propagation for the tracker benchmark (evals/legacy.py):
classical Farneback flow and a learned flow network (:class:`PWCLite`),
both on an explicit device, and mean-flow box shifting.

The port's counterpart of the JAX package's ``evals/flow.py``. The learned
path (``method="model"``) runs :class:`PWCLite`, a small coarse-to-fine
pyramid flow network (shared stride-2 conv feature pyramid, bilinear warp,
a normalized local correlation, residual flow refinement), in plain
PyTorch on an explicit device; its FLOPs per geometry come from
``utils/profiling.flops_of``. Its weights are seeded random until
:meth:`ModelFlow.fit_translations` fits them on synthetic translations.

:func:`farneback_flow` computes OpenCV's ``calcOpticalFlowFarneback`` in
PyTorch (evals/farneback.py). Both paths turn frames gray and halve them
with the host formulas of ``data/color.py`` and ``data/resize.py``, which
equal OpenCV's, and scale the flow back up with OpenCV's float resize. No
OpenCV is imported.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.color import bgr_to_gray_u8, gaussian_blur_f32
from ..data.resize import rescale_u8, resize_linear_f32
from . import farneback
from ..models.detector import resolve_device
from ..models.layers import _fan_in, conv2d_nhwc, trunc_normal_init
from ..train.step import Optimizer
from ..utils.profiling import flops_of


def farneback_flops_per_pixel(
    levels: int = 3,
    pyr_scale: float = 0.5,
    winsize: int = 15,
    iterations: int = 3,
    poly_n: int = 5,
) -> float:
    """Derived FLOPs per input pixel of Farneback flow at the parameters
    :func:`farneback_flow` computes (0.5, 3, 15, 3, 5). Per pixel
    of one pyramid level:

    - polynomial expansion, both frames: a ``poly_n``-tap separable
      correlation onto the 6-term quadratic basis, (3 + 6) * poly_n MACs =
      18 * poly_n FLOPs per frame, x2 frames;
    - per iteration: the 2x2 normal equations from both frames'
      coefficients (~20 FLOPs), a separable ``winsize``-tap blur of their 5
      fields (5 x 2 passes x winsize taps x 2 FLOPs) and the 2x2 solve
      (~10 FLOPs);
    - the pyramid at ``pyr_scale`` a level: area series sum(pyr_scale^(2 l)).

    The JAX package derives the same count (OpenCV's C++ is invisible to
    its FLOP counter), and ``flops_of`` counts no elementwise operation, so
    this stays an operation count, good to tens of percent."""
    per_level = 36.0 * poly_n + iterations * (30.0 + 20.0 * winsize)
    area = sum(pyr_scale ** (2 * lvl) for lvl in range(levels))
    return per_level * area


FARNEBACK_FLOPS_PER_PIXEL = farneback_flops_per_pixel()


def farneback_flow(
    prev_gray: np.ndarray, cur_gray: np.ndarray, downsample: float = 1.0,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Dense flow (H, W, 2) of two uint8 gray frames, OpenCV's
    ``calcOpticalFlowFarneback(prev, cur, None, 0.5, 3, 15, 3, 5, 1.2, 0)``
    computed on ``device`` (evals/farneback.py). ``downsample`` < 1 computes
    it at that fraction of the size (OpenCV's ``resize(fx=downsample)``)
    and scales the field back up (``resize``, divided by ``downsample``)."""
    dev = resolve_device(device)
    if downsample != 1.0:
        small_prev = rescale_u8(prev_gray, downsample)
        small_cur = rescale_u8(cur_gray, downsample)
    else:
        small_prev, small_cur = prev_gray, cur_gray
    pair = torch.from_numpy(np.stack([small_prev, small_cur])).to(dev)
    flow = farneback.calc_flow(pair[0], pair[1])
    if downsample != 1.0:
        flow = farneback.resize_linear(flow, prev_gray.shape[:2]) / downsample
    return flow.permute(1, 2, 0).cpu().numpy()


def _warp(feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear gather of (h, w, c) ``feat`` at each pixel plus its (h, w, 2)
    ``flow`` (x, y), indices clamped to the image."""
    h, w = feat.shape[:2]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=flow.dtype, device=flow.device),
        torch.arange(w, dtype=flow.dtype, device=flow.device),
        indexing="ij",
    )
    x = xs + flow[..., 0]
    y = ys + flow[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]

    def g(yy, xx):
        return feat[yy.clamp(0, h - 1).long(), xx.clamp(0, w - 1).long()]

    return ((1 - wx) * (1 - wy) * g(y0, x0)
            + wx * (1 - wy) * g(y0, x0 + 1)
            + (1 - wx) * wy * g(y0 + 1, x0)
            + wx * wy * g(y0 + 1, x0 + 1))


def _corr(f1: torch.Tensor, f2w: torch.Tensor, radius: int) -> torch.Tensor:
    """Local cost volume of two (h, w, c) maps: the inner product of their
    unit-norm feature vectors for every displacement in [-radius, radius]^2,
    the second map edge-padded; (h, w, (2 radius + 1)^2), dy-major."""
    eps = 1e-6
    a = f1 / (torch.linalg.vector_norm(f1, dim=-1, keepdim=True) + eps)
    b = f2w / (torch.linalg.vector_norm(f2w, dim=-1, keepdim=True) + eps)
    h, w = b.shape[:2]
    rows = torch.arange(-radius, h + radius, device=b.device).clamp(0, h - 1)
    cols = torch.arange(-radius, w + radius, device=b.device).clamp(0, w - 1)
    bp = b[rows][:, cols]
    vols = [
        (a * bp[radius + dy: radius + dy + h, radius + dx: radius + dx + w]).sum(-1)
        for dy in range(-radius, radius + 1)
        for dx in range(-radius, radius + 1)
    ]
    return torch.stack(vols, dim=-1)


def _upsample(flow: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an (h, w, 2) field with half-pixel centers, as
    ``jax.image.resize(..., "bilinear")`` upsamples."""
    out = F.interpolate(flow.permute(2, 0, 1)[None], size=hw, mode="bilinear",
                        align_corners=False)
    return out[0].permute(1, 2, 0)


class _Conv(nn.Module):
    """flax ``nn.Conv(features, (3, 3), strides)``: SAME padding, a bias."""

    def __init__(self, cin: int, cout: int, stride: int, g: torch.Generator):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        with torch.no_grad():
            trunc_normal_init(self.weight, _fan_in(self.weight), 1.0, g)  # lecun_normal

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_nhwc(x, self.weight, self.stride) + self.bias


class PWCLite(nn.Module):
    """Tiny PWC-Net-style pyramid flow network, the JAX package's
    ``PWCLite``. Inputs: two (H, W) float32 gray images in [0, 1], H and W
    multiples of 8 (:class:`ModelFlow` pads); output: (H, W, 2) flow (x, y)
    in pixels.

    A shared 3-level stride-2 conv pyramid (16, 32, 48 channels, SiLU) over
    both frames; coarse to fine, the coarser flow is upsampled and doubled,
    frame 2's features are warped by it, and three convs (32, 16, 2) on the
    cost volume, frame 1's features and the flow predict a residual flow;
    a last x2 upsample. Parameter names follow flax's modules (``enc0``,
    ``dec2_0``, ``flow1``, ...: ``convert.pwclite_params_from_jax``). The
    initial weights are lecun-normal draws from ``generator`` (seed 0 when
    None), not flax's."""

    RADIUS = 3  # cost-volume displacement radius (7x7 = 49 channels)

    def __init__(self, generator: torch.Generator | None = None, feat: int = 16,
                 levels: int = 3):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.levels = levels
        cost = (2 * self.RADIUS + 1) ** 2
        for i in range(levels):
            self.add_module(f"enc{i}", _Conv(1 if i == 0 else feat * i, feat * (i + 1), 2, g))
        for i in reversed(range(levels)):
            self.add_module(f"dec{i}_0", _Conv(cost + feat * (i + 1) + 2, 32, 1, g))
            self.add_module(f"dec{i}_1", _Conv(32, 16, 1, g))
            self.add_module(f"flow{i}", _Conv(16, 2, 1, g))

    def forward(self, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
        x = torch.stack([im1, im2])[..., None]  # both frames through one pyramid
        feats = []
        for i in range(self.levels):
            x = F.silu(getattr(self, f"enc{i}")(x))
            feats.append(x)
        flow = None
        for i in reversed(range(self.levels)):
            f1, f2 = feats[i][0], feats[i][1]
            if flow is None:
                flow = torch.zeros(f1.shape[:2] + (2,), dtype=f1.dtype, device=f1.device)
                f2w = f2
            else:
                flow = 2.0 * _upsample(flow, tuple(f1.shape[:2]))
                f2w = _warp(f2, flow)
            x = torch.cat([_corr(f1, f2w, self.RADIUS), f1, flow], dim=-1)[None]
            x = F.silu(getattr(self, f"dec{i}_0")(x))
            x = F.silu(getattr(self, f"dec{i}_1")(x))
            flow = flow + getattr(self, f"flow{i}")(x)[0]
        return 2.0 * _upsample(flow, tuple(im1.shape))


def translation_pair(rng: np.random.RandomState, ph: int, pw: int):
    """One synthetic training pair: blurred noise (sigma 3) and the same
    noise shifted by a random integer (dx, dy) in [-4, 4]; returns (a, b,
    gt) with gt the (ph, pw, 2) flow (dx, dy)."""
    base = rng.rand(ph + 16, pw + 16).astype(np.float32)
    base = gaussian_blur_f32(base, 3.0)
    base = (base - base.min()) / max(float(np.ptp(base)), 1e-6)
    dx, dy = rng.randint(-4, 5), rng.randint(-4, 5)
    a = base[8: 8 + ph, 8: 8 + pw]
    b = base[8 - dy: 8 - dy + ph, 8 - dx: 8 - dx + pw]
    gt = np.full((ph, pw, 2), (dx, dy), np.float32)
    return a, b, gt


class ModelFlow:
    """:class:`PWCLite` on ``device`` with its FLOPs per input geometry, the
    JAX package's ``ModelFlow``. ``flops`` counts one call by
    ``flops_of``; ``compute`` pads a gray pair to multiples of 8, and warns
    once while the weights are untrained."""

    def __init__(self, seed: int = 0, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.net = PWCLite(torch.Generator().manual_seed(seed)).to(self.device)
        self._flops: dict[tuple[int, int], float] = {}
        self._trained = False
        self._warned_untrained = False

    @staticmethod
    def _pad_hw(h: int, w: int) -> tuple[int, int]:
        return -(-h // 8) * 8, -(-w // 8) * 8

    @torch.no_grad()
    def _apply(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.net(a, b)

    def flops(self, h: int, w: int) -> float:
        """FLOPs of one flow call at the given input geometry (before padding)."""
        key = self._pad_hw(h, w)
        if key not in self._flops:
            zero = torch.zeros(key, device=self.device)
            self._flops[key] = flops_of(self._apply, zero, zero)
        return self._flops[key]

    def compute(self, prev_gray: np.ndarray, cur_gray: np.ndarray) -> np.ndarray:
        """(H, W) uint8/float gray pair -> (H, W, 2) float32 flow."""
        if not self._trained and not self._warned_untrained:
            warnings.warn(
                "ModelFlow.compute() called with untrained (random-init) weights: the flow is "
                "meaningless for tracking. Call fit_translations() first (or load trained "
                "weights).",
                RuntimeWarning,
                stacklevel=2,
            )
            self._warned_untrained = True
        h, w = prev_gray.shape[:2]
        ph, pw = self._pad_hw(h, w)
        a = np.zeros((ph, pw), np.float32)
        b = np.zeros((ph, pw), np.float32)
        a[:h, :w] = np.asarray(prev_gray, np.float32) / 255.0
        b[:h, :w] = np.asarray(cur_gray, np.float32) / 255.0
        out = self._apply(torch.from_numpy(a).to(self.device), torch.from_numpy(b).to(self.device))
        return out.cpu().numpy()[:h, :w]

    def fit_step(self, tx: Optimizer, opt_state: dict, a, b, gt, lr: float):
        """One Adam step on the endpoint loss mean |flow(a, b) - gt|, updating
        the weights in place; returns (opt_state, the loss before the step)."""
        params = dict(self.net.named_parameters())
        to = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)  # noqa: E731
        loss = (self.net(to(a), to(b)) - to(gt)).abs().mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        opt_state = tx.update(dict(zip(params, grads)), opt_state, params, lr)
        return opt_state, float(loss.detach())

    def fit_translations(self, steps: int = 600, size: int = 64, lr: float = 1e-3,
                         seed: int = 0) -> float:
        """Self-supervised fit on synthetic global translations
        (:func:`translation_pair` from ``RandomState(seed)``), Adam at ``lr``
        as ``optax.adam`` computes it (train/step.py's arithmetic, with no
        weight decay and no clip). Returns the last step's mean endpoint
        error in pixels."""
        rng = np.random.RandomState(seed)
        ph, pw = self._pad_hw(size, size)
        tx = Optimizer(weight_decay=0.0, grad_clip_norm=math.inf)
        opt_state = tx.init(dict(self.net.named_parameters()))
        last = 0.0
        for _ in range(steps):
            a, b, gt = translation_pair(rng, ph, pw)
            opt_state, last = self.fit_step(tx, opt_state, a, b, gt, lr)
        self._trained = True
        return last


_MODEL_FLOWS: dict[str, ModelFlow] = {}


def get_model_flow(device: str | torch.device = "cuda") -> ModelFlow:
    """The process's learned-flow model on ``device``, built on first use."""
    key = str(resolve_device(device))
    if key not in _MODEL_FLOWS:
        _MODEL_FLOWS[key] = ModelFlow(device=key)
    return _MODEL_FLOWS[key]


def model_flow(prev_gray: np.ndarray, cur_gray: np.ndarray, downsample: float = 1.0,
               device: str | torch.device = "cuda") -> np.ndarray:
    """Learned flow of two uint8 gray frames, computed at ``downsample`` of
    their size (OpenCV's ``resize(fx=downsample)``) and scaled back up
    (``resize`` of the flow field, divided by ``downsample``)."""
    if downsample != 1.0:
        small_prev = rescale_u8(prev_gray, downsample)
        small_cur = rescale_u8(cur_gray, downsample)
    else:
        small_prev, small_cur = prev_gray, cur_gray
    flow = get_model_flow(device).compute(small_prev, small_cur)
    if downsample != 1.0:
        flow = resize_linear_f32(flow, prev_gray.shape[:2])
        flow /= downsample
    return flow


def flow_flops_per_frame(method: str, h: int, w: int, downsample: float = 1.0,
                         device: str | torch.device = "cuda") -> float:
    """FLOPs charged to one flow call in the blended report: counted for
    the learned model, derived per pixel for Farneback, 0 for 'no'."""
    if method == "no":
        return 0.0
    sh, sw = int(h * downsample), int(w * downsample)
    if method == "model":
        return get_model_flow(device).flops(sh, sw)
    if method == "farneback":
        return float(sh * sw) * FARNEBACK_FLOPS_PER_PIXEL
    raise ValueError(f"unknown flow method '{method}'")


def get_optical_flow(
    prev_frame: np.ndarray,
    cur_frame: np.ndarray,
    method: str = "farneback",
    downsample: float = 1.0,
    device: str | torch.device = "cuda",
) -> np.ndarray | None:
    """Flow between two BGR (or gray) uint8 frames on ``device``: None for
    'no', Farneback for 'farneback', :class:`PWCLite` for 'model'."""
    if method == "no":
        return None
    to_gray = lambda f: bgr_to_gray_u8(f) if f.ndim == 3 else f  # noqa: E731
    if method == "farneback":
        return farneback_flow(to_gray(prev_frame), to_gray(cur_frame), downsample, device)
    if method == "model":
        return model_flow(to_gray(prev_frame), to_gray(cur_frame), downsample, device)
    raise ValueError(
        f"flow method '{method}' not available in this build (use 'farneback', 'model', or 'no')"
    )


def update_bounding_boxes(boxes_xyxy: np.ndarray, flow: np.ndarray | None) -> np.ndarray:
    """Shift each box by the mean flow inside it: integer displacement,
    NaN-safe, clipped to the image."""
    if flow is None or boxes_xyxy.size == 0:
        return boxes_xyxy
    h, w = flow.shape[:2]
    out = boxes_xyxy.copy().astype(np.float32)
    for i, (x1, y1, x2, y2) in enumerate(boxes_xyxy[:, :4]):
        xi1, yi1 = int(max(0, x1)), int(max(0, y1))
        xi2, yi2 = int(min(w, x2)), int(min(h, y2))
        if xi2 <= xi1 or yi2 <= yi1:
            continue
        region = flow[yi1:yi2, xi1:xi2]
        dx = float(np.nan_to_num(np.mean(region[..., 0])))
        dy = float(np.nan_to_num(np.mean(region[..., 1])))
        dx, dy = int(round(dx)), int(round(dy))
        out[i, 0] = np.clip(x1 + dx, 0, w)
        out[i, 1] = np.clip(y1 + dy, 0, h)
        out[i, 2] = np.clip(x2 + dx, 0, w)
        out[i, 3] = np.clip(y2 + dy, 0, h)
    return out
