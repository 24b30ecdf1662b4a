"""Plain float32 decode and non-maximum suppression of the head's maps.

Decode: the DFL expectation over ``reg_max`` bins gives each anchor's
(left, top, right, bottom) distances in grid units; the box is the anchor
point minus / plus them, times the stride, rescaled from the head's
(padded) coordinate space to the image. Scores are the class sigmoids.

NMS: each anchor's best class (the first maximum) and score; candidates
at or above ``conf`` sorted by score (ties to the lower anchor), the
first ``4 * max_det`` kept; classic sequential suppression of any later
candidate whose IoU with a kept one exceeds ``iou``, the boxes of each
class shifted by ``class * CLASS_OFFSET`` px first so that classes never
overlap (the Ultralytics convention, whose float32 rounding the program
shares); the first ``max_det`` kept.
"""

from __future__ import annotations

import torch

from .loss import dfl_expectation, flatten

CLASS_OFFSET = 7680.0


def decode(maps, reg_max: int, image_hw: tuple[int, int]):
    """Raw maps (B, h, w, 4*reg_max + nc) -> (boxes (B, A, 4) xyxy image
    pixels, scores (B, A, nc))."""
    box_logits, cls_logits, anchors, strides = flatten(maps, reg_max)
    d = dfl_expectation(box_logits, reg_max)
    boxes = torch.cat([anchors - d[..., :2], anchors + d[..., 2:]], -1) * strides
    sy = image_hw[0] / (maps[0].shape[1] * 8)
    sx = image_hw[1] / (maps[0].shape[2] * 8)
    boxes = boxes * torch.tensor([sx, sy, sx, sy], dtype=boxes.dtype, device=boxes.device)
    return boxes, torch.sigmoid(cls_logits)


def _iou_row(box, boxes):
    wh = (torch.minimum(box[2:], boxes[:, 2:]) - torch.maximum(box[:2], boxes[:, :2])).clamp(min=0)
    inter = wh[:, 0] * wh[:, 1]
    area = lambda b: (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)  # noqa: E731
    return inter / (area(box) + area(boxes) - inter + 1e-7)


def nms(boxes, scores, conf: float, iou: float, max_det: int):
    """One image: (A, 4), (A, nc) -> (boxes (n, 4), scores (n,), classes
    (n,)) on the host, highest score first."""
    best, cls = scores.max(-1)
    order = torch.sort(torch.where(best >= conf, best, torch.full_like(best, -1.0)),
                       descending=True, stable=True).indices[: 4 * max_det]
    order = order[best[order] >= conf].cpu()
    boxes, best, cls = boxes.cpu()[order], best.cpu()[order], cls.cpu()[order]
    shifted = boxes + (cls.to(boxes.dtype) * CLASS_OFFSET)[:, None]
    keep = torch.ones(len(order), dtype=torch.bool)
    for i in range(len(order)):
        if keep[i]:
            later = torch.arange(len(order)) > i
            keep &= ~(later & (_iou_row(shifted[i], shifted) > iou))
    idx = keep.nonzero()[:, 0][:max_det]
    return boxes[idx], best[idx], cls[idx]
