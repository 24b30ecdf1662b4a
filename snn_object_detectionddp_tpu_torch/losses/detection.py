"""YOLOv8-style detection loss: TAL assignment + CIoU + BCE + DFL.

Component gains come from the config hyp block (box 7.5 / cls 1.0 /
dfl 2.5 / reg_max 16); the scalar training loss is
``(box + cls + dfl) * batch_size`` and the three components are what is
logged per batch.

Label contract: targets arrive padded — (B, M, 5) rows
``[class, cx, cy, w, h]`` normalized to [0, 1] plus a (B, M) validity mask.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models.detect import dfl_expectation, flatten_predictions
from ..ops.anchors import bbox2dist, dist2bbox
from ..ops.boxes import ciou, cxcywh_to_xyxy
from .tal import task_aligned_assign


class LossComponents(NamedTuple):
    total: torch.Tensor  # scalar: (box + cls + dfl) * batch_size
    box: torch.Tensor
    cls: torch.Tensor
    dfl: torch.Tensor
    # Foreground anchors assigned by TAL this batch. Pure observability: a
    # sustained 0 means the assigner's bootstrap starved and the box/dfl
    # losses are silently zero.
    fg: torch.Tensor | float = 0.0

    @property
    def vec3(self) -> torch.Tensor:
        return torch.stack([self.box, self.cls, self.dfl])


def _dfl_loss(
    pred_dist: torch.Tensor,  # (B, A, 4, reg_max) logits
    target_ltrb: torch.Tensor,  # (B, A, 4) in [0, reg_max-1)
) -> torch.Tensor:
    """Distribution focal loss per anchor: cross-entropy against the two
    integer bins bracketing each target distance. -> (B, A). A bin index
    outside [0, reg_max) contributes zero (a gather under a mask, where a
    one-hot would raise)."""
    tl = torch.floor(target_ltrb)
    tr = tl + 1.0
    wl = tr - target_ltrb
    wr = 1.0 - wl
    logp = torch.log_softmax(pred_dist, -1)
    reg_max = pred_dist.shape[-1]

    def ce(bins: torch.Tensor) -> torch.Tensor:
        idx = bins.long()
        ok = (idx >= 0) & (idx < reg_max)
        picked = logp.gather(-1, idx.clamp(0, reg_max - 1)[..., None])[..., 0]
        return -picked * ok

    return (ce(tl) * wl + ce(tr) * wr).mean(-1)


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE-with-logits (elementwise); the JAX package's
    ``optax_sigmoid_bce``."""
    return logits.clamp(min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def detection_loss(
    raw_maps: list[torch.Tensor],
    labels: torch.Tensor,  # (B, M, 5) [cls, cx, cy, w, h] normalized
    label_mask: torch.Tensor,  # (B, M) bool
    num_classes: int,
    reg_max: int = 16,
    gain_box: float = 7.5,
    gain_cls: float = 1.0,
    gain_dfl: float = 2.5,
    sample_mask: torch.Tensor | None = None,  # (B,) bool; False = padding row
    cross_replica_axis: str | None = None,
) -> LossComponents:
    """``sample_mask`` excludes the padding rows of a final partial batch
    from every loss term: with the mask, the loss of a padded batch equals
    the loss of the unpadded batch.

    ``cross_replica_axis`` belongs to data-parallel training, which this
    package does not run yet: anything but None raises."""
    if cross_replica_axis is not None:
        raise NotImplementedError(
            "cross_replica_axis: data-parallel loss normalization is not ported"
        )
    dev = raw_maps[0].device
    if sample_mask is None:
        batch = torch.tensor(float(raw_maps[0].shape[0]), device=dev)
        row_w = None
    else:
        sample_mask = sample_mask.to(dev, torch.float32)
        batch = sample_mask.sum()
        row_w = sample_mask[:, None, None]  # (B, 1, 1)
    batch = batch.clamp(min=1.0)
    box_logits, cls_logits, anchor_points, stride_t = flatten_predictions(
        raw_maps, reg_max, num_classes
    )
    box_logits = box_logits.float()
    cls_logits = cls_logits.float()

    # Image size implied by the P3 map (stride 8).
    img_h = raw_maps[0].shape[1] * 8
    img_w = raw_maps[0].shape[2] * 8

    # Decode predictions to grid-unit xyxy.
    pred_dist = box_logits.reshape(tuple(box_logits.shape[:-1]) + (4, reg_max))
    pred_ltrb = dfl_expectation(box_logits, reg_max)  # (B, A, 4)
    pred_bboxes = dist2bbox(pred_ltrb, anchor_points)  # grid units

    # Ground truth to pixel xyxy.
    labels = labels.to(dev, torch.float32)
    label_mask = label_mask.to(dev, torch.bool)
    gt_labels = labels[..., 0].to(torch.int32)
    gt_cxcywh = labels[..., 1:] * torch.tensor(
        [img_w, img_h, img_w, img_h], dtype=torch.float32, device=dev
    )
    gt_bboxes = cxcywh_to_xyxy(gt_cxcywh)
    mask_gt = label_mask & (gt_cxcywh[..., 2:].sum(-1) > 0)

    # Assignment is a label-construction step, not a differentiable path:
    # both inputs are detached. Without the score detach,
    # grad(pow(score, 0.5)) -> inf once background sigmoids underflow to 0.
    with torch.no_grad():
        assign = task_aligned_assign(
            torch.sigmoid(cls_logits),
            pred_bboxes * stride_t,  # pixels
            anchor_points * stride_t,  # pixels
            gt_labels,
            gt_bboxes,
            mask_gt,
        )

    target_scores_sum = assign.target_scores.sum()
    fg_count = assign.fg_mask.float()
    if row_w is not None:  # padding rows carry no real assignments
        fg_count = fg_count * row_w[..., 0]
    fg_count = fg_count.sum()

    # --- Classification: BCE-with-logits against soft targets -------------
    bce = sigmoid_bce(cls_logits, assign.target_scores)
    if row_w is not None:  # zero padding rows' background BCE
        bce = bce * row_w
    sum_cls = bce.sum()

    # --- Box regression: CIoU on foreground anchors ------------------------
    target_bboxes_grid = assign.target_bboxes / stride_t  # grid units
    weight = assign.target_scores.sum(-1) * assign.fg_mask  # (B, A)
    if row_w is not None:
        weight = weight * row_w[..., 0]
    iou = ciou(pred_bboxes, target_bboxes_grid)  # (B, A)
    sum_box = ((1.0 - iou) * weight).sum()

    # --- DFL ----------------------------------------------------------------
    target_ltrb = bbox2dist(target_bboxes_grid, anchor_points, reg_max)
    sum_dfl = (_dfl_loss(pred_dist, target_ltrb) * weight).sum()

    target_scores_sum = target_scores_sum.clamp(min=1.0)
    box = sum_box / target_scores_sum * gain_box
    cls = sum_cls / target_scores_sum * gain_cls
    dfl_c = sum_dfl / target_scores_sum * gain_dfl
    total = (box + cls + dfl_c) * batch
    return LossComponents(total=total, box=box, cls=cls, dfl=dfl_c, fg=fg_count)


class DetectionLoss:
    """Config-bound callable: ``loss_fn(raw_maps, labels, label_mask,
    sample_mask=None) -> LossComponents``."""

    def __init__(self, num_classes: int, hyp: Any):
        self.num_classes = num_classes
        self.reg_max = hyp.reg_max
        self.gains = (hyp.box, hyp.cls, hyp.dfl)

    def __call__(
        self,
        raw_maps,
        labels,
        label_mask,
        sample_mask=None,
        cross_replica_axis=None,
    ) -> LossComponents:
        return detection_loss(
            raw_maps,
            labels,
            label_mask,
            self.num_classes,
            self.reg_max,
            *self.gains,
            sample_mask=sample_mask,
            cross_replica_axis=cross_replica_axis,
        )
