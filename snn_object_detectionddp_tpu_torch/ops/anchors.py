"""Anchor points and distance<->box transforms for the anchor-free head.

Anchor points are in grid units of each scale, offset to cell centers by
+0.5 (ultralytics ``make_anchors`` / ``dist2bbox`` semantics).
"""

from __future__ import annotations

import torch


def make_anchors(
    feat_shapes: list[tuple[int, int]],
    strides: list[int],
    offset: float = 0.5,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Anchor points (A, 2) concatenated over scales and each anchor's
    stride (A, 1), for a list of (H, W) feature shapes."""
    points, stride_vals = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=dtype, device=device) + offset
        sy = torch.arange(h, dtype=dtype, device=device) + offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        stride_vals.append(
            torch.full((h * w, 1), float(s), dtype=dtype, device=device)
        )
    return torch.cat(points, 0), torch.cat(stride_vals, 0)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor) -> torch.Tensor:
    """ltrb distances (..., A, 4) + anchors (A, 2) -> xyxy boxes (..., A, 4)."""
    lt = distance[..., :2]
    rb = distance[..., 2:]
    return torch.cat([anchor_points - lt, anchor_points + rb], -1)


def bbox2dist(
    bbox_xyxy: torch.Tensor, anchor_points: torch.Tensor, reg_max: int
) -> torch.Tensor:
    """xyxy boxes (..., A, 4) + anchors (A, 2) -> ltrb distances clipped to
    [0, reg_max - 1 - 0.01] for DFL targets."""
    lt = anchor_points - bbox_xyxy[..., :2]
    rb = bbox_xyxy[..., 2:] - anchor_points
    return torch.cat([lt, rb], -1).clamp(0.0, reg_max - 1 - 0.01)
