"""Anchor-free YOLOv8-style detection head with DFL box regression.

Per scale, a 2-conv box branch emitting ``4 * reg_max`` distribution
logits and a 2-conv class branch emitting ``nc`` logits, at strides
(8, 16, 32). :func:`decode_predictions` turns the raw maps into
(boxes, scores) for NMS.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.anchors import dist2bbox, make_anchors
from ..parallel.mesh import current_spatial_group, full_channels, gather_rows
from .layers import ConvBlock, Conv1x1

STRIDES = (8, 16, 32)


class DetectHead(nn.Module):
    """List of 3 maps (B, H/s, W/s, C_s) -> list of 3 raw maps
    (B, H/s, W/s, 4*reg_max + nc) in fp32, box logits first. Under tensor
    parallelism the box and class outputs are gathered whole; under
    spatial parallelism the convs run on the local rows (``rows``: each
    map's global rows) and each raw map is gathered whole by rows, so the
    anchors and the decoding are global."""

    def __init__(self, num_classes: int, feat_channels: tuple[int, int, int],
                 reg_max: int = 16, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes, self.reg_max = num_classes, reg_max
        c2 = max(64, 4 * reg_max)
        c3 = max(feat_channels[0], min(num_classes, 100), 128)
        for i, (ch, stride) in enumerate(zip(feat_channels, STRIDES)):
            setattr(self, f"box{i}_conv1", ConvBlock(ch, c2, dtype=dtype))
            setattr(self, f"box{i}_conv2", ConvBlock(c2, c2, dtype=dtype))
            setattr(self, f"box{i}_out", Conv1x1(c2, 4 * reg_max, 1.0, dtype=dtype))
            # Low-objectness class-bias prior per scale (ultralytics
            # convention): b = log(5 / nc / (640/s)^2).
            prior = math.log(5.0 / num_classes / (640.0 / stride) ** 2)
            setattr(self, f"cls{i}_conv1", ConvBlock(ch, c3, dtype=dtype))
            setattr(self, f"cls{i}_conv2", ConvBlock(c3, c3, dtype=dtype))
            setattr(self, f"cls{i}_out", Conv1x1(c3, num_classes, prior, dtype=dtype))

    def forward(self, feats: list[torch.Tensor], rows=(None, None, None)) -> list[torch.Tensor]:
        outs = []
        for i, (x, n) in enumerate(zip(feats, rows)):
            box = getattr(self, f"box{i}_conv2")(getattr(self, f"box{i}_conv1")(x, rows=n), rows=n)
            box = full_channels(getattr(self, f"box{i}_out")(box), 4 * self.reg_max)
            cls = getattr(self, f"cls{i}_conv2")(getattr(self, f"cls{i}_conv1")(x, rows=n), rows=n)
            cls = full_channels(getattr(self, f"cls{i}_out")(cls), self.num_classes)
            out = torch.cat([box, cls], -1).float()
            outs.append(out if current_spatial_group() is None else gather_rows(out, n))
        return outs


def dfl_expectation(box_logits: torch.Tensor, reg_max: int) -> torch.Tensor:
    """(..., 4*reg_max) -> (..., 4) softmax expectation over reg_max bins."""
    shape = tuple(box_logits.shape[:-1]) + (4, reg_max)
    probs = torch.softmax(box_logits.reshape(shape), -1)
    bins = torch.arange(reg_max, dtype=probs.dtype, device=probs.device)
    return (probs * bins).sum(-1)


def flatten_predictions(raw_maps: list[torch.Tensor], reg_max: int, num_classes: int):
    """Concatenate per-scale raw maps over anchors: (box_logits (B, A,
    4*reg_max), cls_logits (B, A, nc), anchor_points (A, 2), strides (A, 1))."""
    feat_shapes = [(m.shape[1], m.shape[2]) for m in raw_maps]
    anchor_points, stride_t = make_anchors(
        feat_shapes, list(STRIDES), device=raw_maps[0].device
    )
    box_list, cls_list = [], []
    for m in raw_maps:
        flat = m.reshape(m.shape[0], -1, m.shape[-1])
        box_list.append(flat[..., : 4 * reg_max])
        cls_list.append(flat[..., 4 * reg_max :])
    return torch.cat(box_list, 1), torch.cat(cls_list, 1), anchor_points, stride_t


def decode_predictions(
    raw_maps: list[torch.Tensor],
    reg_max: int,
    num_classes: int,
    image_hw: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw head maps -> (boxes_xyxy (B, A, 4) in pixels, scores (B, A, nc)).

    When H/W is not a multiple of 64 the decoder's resize chain emits a P3
    map of ceil-rounded size (64 rows for a 480-row input), so the head's
    coordinate space is a stretched image; ``image_hw`` rescales boxes back
    to true image pixels."""
    box_logits, cls_logits, anchor_points, stride_t = flatten_predictions(
        raw_maps, reg_max, num_classes
    )
    dist = dfl_expectation(box_logits, reg_max)
    boxes = dist2bbox(dist, anchor_points) * stride_t
    if image_hw is not None:
        sy = image_hw[0] / (raw_maps[0].shape[1] * STRIDES[0])
        sx = image_hw[1] / (raw_maps[0].shape[2] * STRIDES[0])
        boxes = boxes * torch.tensor([sx, sy, sx, sy], dtype=boxes.dtype,
                                     device=boxes.device)
    return boxes, torch.sigmoid(cls_logits)
