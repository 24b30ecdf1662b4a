"""Box geometry on the last axis of 4 box coordinates: format conversions,
area, pairwise and aligned IoU, CIoU, rescaling. All functions are plain
tensor ops and differentiable."""

from __future__ import annotations

import math

import torch

EPS = 1e-7


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) [cx, cy, w, h] -> [x1, y1, x2, y2]."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2.0, cy - h / 2.0, cx + w / 2.0, cy + h / 2.0], -1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) [x1, y1, x2, y2] -> [cx, cy, w, h]."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2.0, (y1 + y2) / 2.0, x2 - x1, y2 - y1], -1)


def box_area(boxes_xyxy: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (...,) area, clamped at zero."""
    w = (boxes_xyxy[..., 2] - boxes_xyxy[..., 0]).clamp(min=0.0)
    h = (boxes_xyxy[..., 3] - boxes_xyxy[..., 1]).clamp(min=0.0)
    return w * h


def pairwise_iou(a_xyxy: torch.Tensor, b_xyxy: torch.Tensor) -> torch.Tensor:
    """IoU matrix between (..., N, 4) and (..., M, 4) -> (..., N, M)."""
    a = a_xyxy[..., :, None, :]
    b = b_xyxy[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = box_area(a_xyxy)[..., :, None]
    area_b = box_area(b_xyxy)[..., None, :]
    union = area_a + area_b - inter
    return inter / (union + EPS)


def elementwise_iou(a_xyxy: torch.Tensor, b_xyxy: torch.Tensor) -> torch.Tensor:
    """IoU between aligned boxes: (..., 4) x (..., 4) -> (...,)."""
    lt = torch.maximum(a_xyxy[..., :2], b_xyxy[..., :2])
    rb = torch.minimum(a_xyxy[..., 2:], b_xyxy[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a_xyxy) + box_area(b_xyxy) - inter
    return inter / (union + EPS)


def ciou(a_xyxy: torch.Tensor, b_xyxy: torch.Tensor) -> torch.Tensor:
    """Complete IoU between aligned (broadcastable) boxes:
    ``IoU - rho2/c2 - alpha*v`` with alpha held constant under the
    gradient, as the CIoU paper prescribes."""
    iou = elementwise_iou(a_xyxy, b_xyxy)
    # Enclosing box diagonal.
    lt = torch.minimum(a_xyxy[..., :2], b_xyxy[..., :2])
    rb = torch.maximum(a_xyxy[..., 2:], b_xyxy[..., 2:])
    cwh = (rb - lt).clamp(min=0.0)
    c2 = cwh[..., 0] ** 2 + cwh[..., 1] ** 2 + EPS
    # Center distance.
    a_c = (a_xyxy[..., :2] + a_xyxy[..., 2:]) / 2.0
    b_c = (b_xyxy[..., :2] + b_xyxy[..., 2:]) / 2.0
    rho2 = ((a_c - b_c) ** 2).sum(-1)
    # Aspect-ratio consistency term.
    aw = a_xyxy[..., 2] - a_xyxy[..., 0]
    ah = a_xyxy[..., 3] - a_xyxy[..., 1]
    bw = b_xyxy[..., 2] - b_xyxy[..., 0]
    bh = b_xyxy[..., 3] - b_xyxy[..., 1]
    v = (4.0 / math.pi**2) * (
        torch.atan(bw / (bh + EPS)) - torch.atan(aw / (ah + EPS))
    ) ** 2
    alpha = (v / (v - iou + (1.0 + EPS))).detach()
    return iou - rho2 / c2 - alpha * v


def scale_boxes(
    boxes_xyxy: torch.Tensor,
    from_shape: tuple[int, int],
    to_shape: tuple[int, int],
) -> torch.Tensor:
    """Rescale boxes from one image shape (H, W) to another, then clip to
    it. No letterbox padding exists in this pipeline, so scaling is a pure
    per-axis ratio."""
    fh, fw = from_shape
    th, tw = to_shape
    sx, sy = tw / fw, th / fh
    out = boxes_xyxy * torch.tensor([sx, sy, sx, sy], dtype=boxes_xyxy.dtype,
                                    device=boxes_xyxy.device)
    return torch.stack(
        [out[..., 0].clamp(0, tw), out[..., 1].clamp(0, th),
         out[..., 2].clamp(0, tw), out[..., 3].clamp(0, th)], -1)
