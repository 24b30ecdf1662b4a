"""Top-level spiking temporal detector: SpikingBackbone -> TemporalUNet ->
DetectHead, and the config-bound :class:`Detector` wrapper.

The window is the unit, with the caller owning state:

    raw_maps, state = detector.apply(params, frames_t, state)

with ``frames_t`` time-major (T, B, H, W, 3). Streaming per-frame inference
is the T=1 case carrying ``state``. ``params`` is a flat dict of tensors
(``init_params``, or ``convert.params_from_jax`` for a JAX checkpoint); the
module itself is a parameter-free skeleton on the ``meta`` device, run with
``torch.func.functional_call``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
from torch import nn

from ..config import Config
from .backbone import SpikingBackbone, preset_channels
from .detect import DetectHead, decode_predictions
from .lif import LIFParams
from .unet import TemporalUNet


class SNNTemporalDetector(nn.Module):
    """(T, B, H, W, 3) frames -> 3 raw detection maps (last timestep, or
    every timestep folded to T*B with ``all_steps``) + recurrent state."""

    def __init__(self, num_classes: int, reg_max: int = 16,
                 lif: LIFParams = LIFParams(),
                 backbone_channels: tuple[int, ...] = (48, 128, 256, 512),
                 backbone_depth: int = 1, stem: str = "s2d", unet_base: int = 128,
                 bottleneck: str = "convlstm", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        feat = tuple(backbone_channels[1:])
        self.backbone = SpikingBackbone(lif, backbone_channels, backbone_depth,
                                        stem, dtype=dtype)
        self.unet = TemporalUNet(lif, feat, unet_base, bottleneck, dtype=dtype)
        self.head = DetectHead(num_classes, feat, reg_max, dtype=dtype)

    def forward(self, frames_t: torch.Tensor, state: dict | None = None,
                all_steps: bool = False, state_only: bool = False):
        """``state_only`` advances the recurrent state and returns
        (None, state) without running the decoder and the head."""
        state = state or {}
        feats, bstate = self.backbone(frames_t, state.get("backbone"))
        refined, ustate = self.unet(feats, state.get("unet"), all_steps=all_steps,
                                    state_only=state_only)
        new_state = {"backbone": bstate, "unet": ustate}
        if state_only:
            return None, new_state
        return self.head(list(refined)), new_state


def set_tf32_policy(precision: str) -> None:
    """Set PyTorch's TF32 switches for a process that runs ``precision``
    (``runtime.precision``); the command lines (main, eval_2, serve) call it
    before they build a model.

    - ``"f32"``: cuDNN convs and CUDA matmuls in full fp32, no TF32.
    - ``"bf16"``: cuDNN convs may use TF32. Every conv of this precision
      that runs in fp32 takes bf16-valued operands (``conv2d_nhwc``'s
      ``f32_result``), and TF32 holds a bf16 value exactly, so each product
      is exact and only the summation order can differ. CUDA matmuls stay
      full fp32: an fp32 matmul of operands that are not bf16-valued must
      not round them.

    The switches are global to the process, not to a thread: the serving
    thread and the loader's threads see the same setting, so one process
    runs one precision."""
    if precision not in ("f32", "bf16"):
        raise ValueError(f"precision must be 'f32' or 'bf16', got {precision!r}")
    torch.backends.cudnn.allow_tf32 = precision == "bf16"
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def tf32_policy(precision: str):
    """``set_tf32_policy(precision)`` inside a ``with`` block; the switches
    are restored on leaving it (an fp32 check inside a bf16 process)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    set_tf32_policy(precision)
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on; a CUDA request without a card
    raises (there is no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run on the CPU"
        )
    return dev


@dataclass
class Detector:
    """Config-bound wrapper around the module skeleton."""

    module: SNNTemporalDetector
    cfg: Config
    device: torch.device

    @classmethod
    def from_config(cls, cfg: Config, device: str | torch.device = "cuda") -> "Detector":
        dev = resolve_device(device)
        chans, depth = preset_channels(cfg.model.yolo_model_name, cfg.model.width_mult)
        s = cfg.model.spike
        lif = LIFParams(threshold=s.threshold, decay=s.decay,
                        surrogate_slope=s.surrogate_slope, reset=s.reset)
        bottleneck = (
            cfg.model.bottleneck
            if cfg.model.bottleneck in ("convlstm", "lif", "lstm")
            else ("convlstm" if cfg.model.use_conv_lstm else "lif")
        )
        dtype = torch.bfloat16 if cfg.runtime.precision == "bf16" else torch.float32
        with torch.device("meta"):
            module = SNNTemporalDetector(
                num_classes=cfg.model.num_classes,
                reg_max=cfg.model.hyp.reg_max,
                lif=lif,
                backbone_channels=chans,
                backbone_depth=depth,
                stem=cfg.model.stem,
                unet_base=int(cfg.model.width_mult * 128),
                bottleneck=bottleneck,
                dtype=dtype,
            )
        return cls(module=module, cfg=cfg, device=dev)

    @property
    def dtype(self) -> torch.dtype:
        return self.module.dtype

    def init_params(self, generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """Fresh fp32 parameters following the JAX package's initializers
        (he_normal convs, xavier ConvLSTM gates, forget bias 1, head bias
        priors). Drawn on the CPU from ``generator`` (seed 0 when None) in a
        fixed order, then moved to the detector's device, so one seed gives
        the same weights on every device."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        params = {}
        for mod_name, mod in self.module.named_modules():
            for name, p in mod.named_parameters(recurse=False):
                t = torch.empty(p.shape, dtype=torch.float32)
                with torch.no_grad():
                    mod.init_param(name, t, generator)
                params[f"{mod_name}.{name}" if mod_name else name] = t.to(self.device)
        return params

    @torch.no_grad()
    def apply(self, params: dict, frames_t: torch.Tensor, state: dict | None = None,
              all_steps: bool = False):
        """Gradient-free forward (serving, evaluation)."""
        return self.apply_train(params, frames_t, state, all_steps=all_steps)

    def apply_train(self, params: dict, frames_t: torch.Tensor, state: dict | None = None,
                    all_steps: bool = False, state_only: bool = False):
        """Forward that records a gradient where ``params`` (or the state)
        require one: on the card the spiking blocks then run the
        residual-saving forward and the backward kernel."""
        return torch.func.functional_call(
            self.module, params, (frames_t, state),
            {"all_steps": all_steps, "state_only": state_only}, strict=True,
        )

    @torch.no_grad()
    def spike_rates(self, params: dict, frames_t: torch.Tensor) -> dict[str, float]:
        """Mean firing rate of every spiking block for one batch — the SNN
        activity/sparsity diagnostic (flat dict: 'backbone/stem1' -> rate).
        One device-to-host copy for all blocks."""
        from .layers import SpikingConvBlock

        rates = {}

        def record(name):
            def hook(mod, inp, out):  # returns None: the output passes through
                rates[name.replace(".", "/")] = out[0].float().mean()
            return hook

        hooks = [m.register_forward_hook(record(name))
                 for name, m in self.module.named_modules() if isinstance(m, SpikingConvBlock)]
        try:
            self.apply(params, frames_t)
        finally:
            for h in hooks:
                h.remove()
        return dict(zip(rates, torch.stack(list(rates.values())).tolist())) if rates else {}

    def decode(self, raw_maps, image_hw: tuple[int, int] | None = None):
        """Raw maps -> (boxes_xyxy pixels, class scores); pass the true
        ``image_hw`` for image-space boxes."""
        return decode_predictions(raw_maps, self.cfg.model.hyp.reg_max,
                                  self.cfg.model.num_classes, image_hw=image_hw)

    def detect_image(self, params: dict, image_u8: torch.Tensor,
                     encoding: str = "direct", conf: float = 0.3,
                     iou: float = 0.45, max_det: int = 300) -> dict:
        """Single-image detection at T = cfg.model.timesteps with the frame
        repeated every timestep ("direct"). image_u8 (B, H, W, 3) uint8;
        returns the fixed-shape NMS dict."""
        from ..data.encoding import encode_direct
        from ..ops.nms import batched_nms

        if encoding != "direct":
            raise ValueError(f"unknown or unported encoding '{encoding}'")
        frames = encode_direct(image_u8.to(self.device), self.cfg.model.timesteps,
                               dtype=self.dtype)
        raw_maps, _ = self.apply(params, frames)
        boxes, scores = self.decode(raw_maps, image_hw=tuple(image_u8.shape[1:3]))
        return batched_nms(boxes, scores, conf_thres=conf, iou_thres=iou, max_det=max_det)
