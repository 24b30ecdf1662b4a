"""Top-level spiking temporal detector: SpikingBackbone -> TemporalUNet ->
DetectHead, and the config-bound :class:`Detector` wrapper.

The window is the unit, with the caller owning state:

    raw_maps, state = detector.apply(params, frames_t, state)

with ``frames_t`` time-major (T, B, H, W, 3). Streaming per-frame inference
is the T=1 case carrying ``state``. ``params`` is a flat dict of tensors
(``init_params``, or ``convert.params_from_jax`` for a JAX checkpoint); the
module itself is a parameter-free skeleton on the ``meta`` device, run with
``torch.func.functional_call``.

Tensor-parallel inference: ``detector.apply(shards, frames_t, state,
mesh=mesh)`` with ``shards = tp_shard_params(params, mesh)``
(parallel/mesh.py) runs every layer on this rank's channel shards and
returns the full raw maps; the recurrent state it returns stays
channel-sharded, and :meth:`Detector.gather_state` makes it whole.

Spatial parallelism (training and evaluation): ``detector.apply(params,
frames_rows, state, mesh=mesh, height=H)`` on every rank of a spatial
group, each with its rows ``row_partition(H)`` of the frames
(``parallel.mesh.spatial_rows``), returns the whole raw maps on every rank
and this rank's rows of the recurrent state.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
from torch import nn

from ..config import Config
from ..parallel.mesh import (
    current_spatial_group,
    full_channels,
    gather_rows,
    spatial_parallel,
    spatial_rows,
    spatial_sum,
    tensor_parallel,
)
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
        sg = current_spatial_group()
        rows = None if sg is None else sg.height
        feats, bstate = self.backbone(frames_t, state.get("backbone"), rows=rows)
        p3_rows = None if rows is None else -(-self.backbone.stem_rows(rows) // 2)
        refined, ustate = self.unet(feats, state.get("unet"), all_steps=all_steps,
                                    state_only=state_only, rows=p3_rows)
        new_state = {"backbone": bstate, "unet": ustate}
        if state_only:
            return None, new_state
        up = self.unet.decoder_rows(p3_rows)
        return self.head(list(refined), rows=(up[6], up[5], up[4])), new_state


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
              all_steps: bool = False, mesh=None, height: int | None = None):
        """Gradient-free forward (serving, evaluation). With a ``mesh``
        that has a tensor axis, ``params`` are this rank's shards
        (``tp_shard_params``) and every rank of the tensor group must call
        this together. With a spatial axis, ``frames_t`` are this rank's
        rows of frames of ``height`` global rows, every rank of the spatial
        group calls this together and each gets the whole raw maps."""
        with tensor_parallel(mesh):
            return self.apply_train(params, frames_t, state, all_steps=all_steps, mesh=mesh,
                                    height=height)

    @torch.no_grad()
    def gather_state(self, state: dict, mesh=None) -> dict:
        """The recurrent state of a tensor- or spatial-parallel forward
        made whole: each leaf's channel shards gathered over the tensor
        group, or its rows over the spatial group (a leaf that is already
        whole is kept). Every rank of the group must call this together."""

        def rows_whole(x):
            n = spatial_sum(x.new_tensor([float(x.shape[-3])]))
            return gather_rows(x, int(n.item()))

        def walk(node, mod):
            if isinstance(node, dict):
                return {k: walk(v, getattr(mod, k)) for k, v in node.items()}
            if isinstance(node, (tuple, list)):
                return type(node)(walk(x, mod) for x in node)
            if current_spatial_group() is not None:  # the token LSTM's carry is whole
                return node if getattr(mod, "rows_replicated", False) else rows_whole(node)
            return full_channels(node, getattr(mod, "features", None) or mod.hidden)

        with tensor_parallel(mesh), spatial_parallel(mesh):
            return walk(state, self.module)

    def apply_train(self, params: dict, frames_t: torch.Tensor, state: dict | None = None,
                    all_steps: bool = False, state_only: bool = False, mesh=None,
                    height: int | None = None):
        """Forward that records a gradient where ``params`` (or the state)
        require one: on the card the spiking blocks then run the
        residual-saving forward and the backward kernel. ``mesh`` /
        ``height``: as :meth:`apply`, for a spatial axis (the context is
        entered here, so a checkpoint's recompute runs sharded too)."""
        if mesh is not None and mesh.spatial > 1 and height is None:
            raise ValueError("a spatial mesh needs the frames' global row count (height=)")
        with spatial_parallel(mesh, height):
            return torch.func.functional_call(
                self.module, params, (frames_t, state),
                {"all_steps": all_steps, "state_only": state_only}, strict=True,
            )

    def rows_replicated_params(self) -> set:
        """Names of the parameters every spatial rank uses the same way on
        whole maps (the token LSTM): their gradients are whole on every
        rank, so a spatial step does not sum them."""
        return {f"{mn}.{pn}" for mn, m in self.module.named_modules()
                if getattr(m, "rows_replicated", False)
                for pn, _ in m.named_parameters(recurse=False)}

    @torch.no_grad()
    def spike_rates(self, params: dict, frames_t: torch.Tensor, mesh=None) -> dict[str, float]:
        """Mean firing rate of every spiking block for one batch — the SNN
        activity/sparsity diagnostic (flat dict: 'backbone/stem1' -> rate).
        One device-to-host copy for all blocks. With a spatial ``mesh``
        every rank of the spatial group calls this with the whole frames,
        runs its rows and gets the rates of the whole maps (spike and pixel
        counts summed over the group)."""
        from .layers import SpikingConvBlock

        rates = {}
        sharded = mesh is not None and mesh.spatial > 1

        def record(name):
            def hook(mod, inp, out):  # returns None: the output passes through
                s = out[0].float()
                rates[name.replace(".", "/")] = (torch.stack([s.sum(), s.new_tensor(s.numel())])
                                                 if sharded else s.mean())
            return hook

        hooks = [m.register_forward_hook(record(name))
                 for name, m in self.module.named_modules() if isinstance(m, SpikingConvBlock)]
        try:
            self.apply(params, spatial_rows(frames_t, mesh), mesh=mesh,
                       height=frames_t.shape[-3])
        finally:
            for h in hooks:
                h.remove()
        if not rates:
            return {}
        values = torch.stack(list(rates.values()))
        if sharded:
            with spatial_parallel(mesh):
                counts = spatial_sum(values)
            values = counts[:, 0] / counts[:, 1]
        return dict(zip(rates, values.tolist()))

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
