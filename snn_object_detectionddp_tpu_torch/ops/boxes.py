"""Box geometry: area and pairwise IoU on the last axis of xyxy boxes."""

from __future__ import annotations

import torch

EPS = 1e-7


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
