"""Model export for deployment: ``torch.export`` programs saved as ``.pt2``.

The whole inference program (uint8 frames -> ``preprocess_video`` ->
the temporal SNN forward -> ``decode_predictions`` -> ``batched_nms``) is
traced into one exported program with the detector's weights as the
program's own parameters ("baked in"), saved with ``torch.export.save``
and loaded back with :func:`load_serving`. The streaming pair exports the
first-frame and the steady-state programs; the recurrent state (the
detector's nested dict of tensors) travels between them as a pytree.

What the trace needs from the rest of the package:

- the six LIF kernels are the operators of kernels/ops.py, whose fake
  implementations ``torch.export`` traces through (no launch, no host
  read): every spiking block is one ``snn_torch::affine_lif_fwd`` node,
  which launches the CUDA kernel when the loaded program runs on the card;
- NMS's fixed point is a ``while_loop`` operator under export
  (ops/nms.py::_fixed_point), the same boolean sweeps as the eager loop.

Shapes are static: a program serves the batch and frame size it was
exported at, as the JAX package's StableHLO export does. Unlike a StableHLO
file, a ``.pt2`` that holds the custom operators loads only in a process
that has registered them: :func:`load_serving` imports kernels/ops.py
first. A loaded program runs under the loading process's TF32 switches:
call ``models.detector.set_tf32_policy(precision)`` first, as the command
lines do, for the numbers of the eager path.
"""

from __future__ import annotations

import copy
from pathlib import Path

import torch
from torch import nn
from torch.utils._pytree import tree_map, tree_unflatten

from ..data.encoding import preprocess_video
from ..kernels import ops  # noqa: F401  (registers torch.ops.snn_torch for load_serving)
from ..models.detect import decode_predictions
from ..ops.nms import batched_nms


def _baked(detector, params: dict) -> nn.Module:
    """The detector's module with ``params`` as its own parameters (the
    tensors themselves, not copies), frozen."""
    net = copy.deepcopy(detector.module)  # a parameter-free meta skeleton
    net.load_state_dict(params, strict=True, assign=True)
    return net.requires_grad_(False)


class _Program(nn.Module):
    """The baked detector followed by decode and NMS. ``forward`` of a
    subclass is one exported signature."""

    def __init__(self, net: nn.Module, cfg, conf: float, iou: float, max_det: int):
        super().__init__()
        self.net = net
        self.reg_max, self.num_classes = cfg.model.hyp.reg_max, cfg.model.num_classes
        self.conf, self.iou, self.max_det = conf, iou, max_det

    def run(self, images_u8: torch.Tensor, state):
        """(B, T, H, W, 3) uint8 and a recurrent state (None: zeros) ->
        (the fixed-shape NMS dict, the new state)."""
        frames = preprocess_video(images_u8, dtype=self.net.dtype)
        raw, new_state = self.net(frames, state)
        boxes, scores = decode_predictions(raw, self.reg_max, self.num_classes,
                                           image_hw=tuple(images_u8.shape[2:4]))
        out = batched_nms(boxes, scores, conf_thres=self.conf, iou_thres=self.iou,
                          max_det=self.max_det)
        return out, new_state


class _Batch(_Program):
    def forward(self, images_u8):
        return self.run(images_u8, None)[0]


class _Init(_Program):
    def forward(self, image_u8):
        return self.run(image_u8[:, None], None)


class _Step(_Program):
    def forward(self, image_u8, state):
        return self.run(image_u8[:, None], state)


def build_serving_fn(detector, params: dict, conf: float = 0.25, iou: float = 0.45,
                     max_det: int = 300) -> nn.Module:
    """(B, T, H, W, 3) uint8 -> fixed-shape NMS dict, params baked in: a
    module on the detector's device, run eagerly or exported."""
    return _Batch(_baked(detector, params), detector.cfg, conf, iou, max_det)


def build_streaming_fns(detector, params: dict, conf: float = 0.25, iou: float = 0.45,
                        max_det: int = 100) -> tuple[nn.Module, nn.Module]:
    """Per-frame streaming pair with carried recurrent state, params baked
    in (one copy shared by both):

    - ``init``: (B, H, W, 3) uint8 -> (nms_dict, state)   [first frame]
    - ``step``: ((B, H, W, 3) uint8, state) -> (nms_dict, state)

    As in serve.DetectionService, the first frame runs from a zero state;
    the two signatures are two programs."""
    net = _baked(detector, params)
    return (_Init(net, detector.cfg, conf, iou, max_det),
            _Step(net, detector.cfg, conf, iou, max_det))


def _save(program: torch.export.ExportedProgram, path) -> str:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, path)
    return str(path)


def _export(module: nn.Module, args: tuple) -> torch.export.ExportedProgram:
    return torch.export.export(module, args, strict=False)


def _state_example(init_program: torch.export.ExportedProgram):
    """Zeros shaped like the recurrent state the exported init program
    returns, read off its outputs' fake values (nothing runs: the
    counterpart of the JAX package's ``jax.eval_shape``)."""
    output = next(n for n in init_program.graph.nodes if n.op == "output")
    values = [node.meta["val"] for node in output.args[0]]
    _, state = tree_unflatten(values, init_program.call_spec.out_spec)
    return tree_map(lambda v: torch.zeros(v.shape, dtype=v.dtype, device=v.device), state)


def export_serving(detector, params: dict, path, batch: int = 1, timesteps: int | None = None,
                   image_hw: tuple[int, int] | None = None, **nms_kwargs) -> str:
    """Export the serving program for (batch, T, H, W, 3) uint8 frames and
    save it to ``path`` (a ``.pt2`` archive); returns the path. Tracing
    launches no kernel."""
    t = timesteps or detector.cfg.model.timesteps
    h, w = image_hw or detector.cfg.model.image_size
    example = torch.zeros((batch, t, h, w, 3), dtype=torch.uint8, device=detector.device)
    return _save(_export(build_serving_fn(detector, params, **nms_kwargs), (example,)), path)


def export_streaming(detector, params: dict, init_path, step_path, batch: int = 1,
                     image_hw: tuple[int, int] | None = None, **nms_kwargs) -> tuple[str, str]:
    """Export the streaming (init, step) pair for (batch, H, W, 3) uint8
    frames to two ``.pt2`` archives; returns their paths. The step
    program's state signature is the one the init program returns.
    Tracing launches no kernel."""
    h, w = image_hw or detector.cfg.model.image_size
    init, step = build_streaming_fns(detector, params, **nms_kwargs)
    example = torch.zeros((batch, h, w, 3), dtype=torch.uint8, device=detector.device)
    init_program = _export(init, (example,))
    step_program = _export(step, (example, _state_example(init_program)))
    return _save(init_program, init_path), _save(step_program, step_path)


class LoadedProgram:
    """A program read back by :func:`load_serving`. ``call`` takes the
    exported signature's arguments (tensors or numpy arrays, moved to the
    program's device) and returns its outputs as tensors."""

    def __init__(self, exported: torch.export.ExportedProgram):
        self.exported = exported
        self.module = exported.module()
        self.device = next(iter(exported.state_dict.values())).device

    def call(self, *args):
        return self.module(*tree_map(lambda x: torch.as_tensor(x).to(self.device), args))


def load_serving(path) -> LoadedProgram:
    """Read a program that :func:`export_serving` or :func:`export_streaming`
    saved; returns an object with ``.call``."""
    return LoadedProgram(torch.export.load(str(path)))
