"""Plain float32 YOLOv8-style detection loss: task-aligned assignment,
CIoU, BCE and DFL, as the program's loss defines them.

The scalar is ``(box + cls + dfl) * batch``, each term normalised by the
sum of the assigned soft targets. The assignment is label construction
and carries no gradient. Labels arrive padded: (B, M, 5) rows ``[class,
cx, cy, w, h]`` normalised to [0, 1] and a (B, M) mask.
"""

from __future__ import annotations

import math

import torch

from .model import STRIDES

BOX_EPS = 1e-7
TAL_EPS = 1e-9
TOPK, ALPHA, BETA = 10, 0.5, 6.0


def make_anchors(shapes, device):
    points, strides = [], []
    for (h, w), s in zip(shapes, STRIDES):
        gy, gx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32) + 0.5,
                                torch.arange(w, device=device, dtype=torch.float32) + 0.5,
                                indexing="ij")
        points.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        strides.append(torch.full((h * w, 1), float(s), device=device))
    return torch.cat(points), torch.cat(strides)


def flatten(maps, reg_max):
    """Raw maps -> (box logits (B, A, 4*reg_max), class logits (B, A, nc),
    anchor points (A, 2) in grid units, strides (A, 1))."""
    anchors, strides = make_anchors([(m.shape[1], m.shape[2]) for m in maps], maps[0].device)
    flat = [m.reshape(m.shape[0], -1, m.shape[-1]) for m in maps]
    return (torch.cat([f[..., : 4 * reg_max] for f in flat], 1),
            torch.cat([f[..., 4 * reg_max:] for f in flat], 1), anchors, strides)


def dfl_expectation(box_logits, reg_max):
    probs = torch.softmax(box_logits.reshape(box_logits.shape[:-1] + (4, reg_max)), -1)
    return (probs * torch.arange(reg_max, dtype=probs.dtype, device=probs.device)).sum(-1)


def xyxy(cxcywh):
    cx, cy, w, h = cxcywh.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _area(b):
    return (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)


def iou_aligned(a, b):
    wh = (torch.minimum(a[..., 2:], b[..., 2:]) - torch.maximum(a[..., :2], b[..., :2])).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (_area(a) + _area(b) - inter + BOX_EPS)


def ciou(a, b):
    """Complete IoU of broadcastable xyxy boxes, alpha held constant."""
    iou = iou_aligned(a, b)
    cwh = (torch.maximum(a[..., 2:], b[..., 2:]) - torch.minimum(a[..., :2], b[..., :2])).clamp(min=0)
    c2 = cwh[..., 0] ** 2 + cwh[..., 1] ** 2 + BOX_EPS
    rho2 = (((a[..., :2] + a[..., 2:]) - (b[..., :2] + b[..., 2:])) / 2).square().sum(-1)
    aw, ah = a[..., 2] - a[..., 0], a[..., 3] - a[..., 1]
    bw, bh = b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]
    v = (4 / math.pi ** 2) * (torch.atan(bw / (bh + BOX_EPS)) - torch.atan(aw / (ah + BOX_EPS))) ** 2
    alpha = (v / (v - iou + (1 + BOX_EPS))).detach()
    return iou - rho2 / c2 - alpha * v


@torch.no_grad()
def assign(scores, boxes, anchors, gt_cls, gt_boxes, gt_mask):
    """Task-aligned assignment: (target boxes (B, A, 4), target scores (B,
    A, nc), foreground (B, A))."""
    b, a, nc = scores.shape
    m = gt_cls.shape[1]
    x, y = anchors[:, 0], anchors[:, 1]
    g = [gt_boxes[..., i][..., None] for i in range(4)]
    inside = (x - g[0] > TAL_EPS) & (y - g[1] > TAL_EPS) & (g[2] - x > TAL_EPS) & (g[3] - y > TAL_EPS)
    overlaps = ciou(gt_boxes[:, :, None, :], boxes[:, None, :, :]).clamp(min=0)
    ok = (gt_cls >= 0) & (gt_cls < nc)
    cls_score = scores.transpose(1, 2).gather(1, gt_cls.clamp(0, nc - 1)[..., None].expand(b, m, a))
    cls_score = cls_score * ok[..., None]
    valid = inside & gt_mask[..., None]
    align = torch.where(valid, cls_score.pow(ALPHA) * overlaps.pow(BETA), torch.zeros_like(overlaps))
    vals, idx = torch.sort(align, dim=-1, descending=True, stable=True)
    pos = torch.zeros_like(valid).scatter_(-1, idx[..., :TOPK], vals[..., :TOPK] > TAL_EPS) & valid
    fg = pos.sum(1) > 0
    gt_idx = torch.where(pos, overlaps, torch.full_like(overlaps, -1.0)).argmax(1)
    pos = pos & (gt_idx[:, None, :] == torch.arange(m, device=scores.device)[None, :, None])
    labels = torch.where(fg, gt_cls.gather(1, gt_idx), torch.zeros_like(gt_idx))
    t_boxes = gt_boxes.gather(1, gt_idx[..., None].expand(b, a, 4))
    t_scores = (labels[..., None] == torch.arange(nc, device=scores.device)).float() * fg[..., None]
    align = torch.where(pos, align, torch.zeros_like(align))
    peak_overlap = torch.where(pos, overlaps, torch.zeros_like(overlaps)).amax(-1, keepdim=True)
    norm = (align * peak_overlap / (align.amax(-1, keepdim=True) + TAL_EPS)).amax(1)
    return t_boxes, t_scores * norm[..., None], fg


def _dfl(pred_dist, target):
    tl = torch.floor(target)
    wl = tl + 1 - target
    logp = torch.log_softmax(pred_dist, -1)
    reg = pred_dist.shape[-1]

    def ce(bins):
        i = bins.long()
        ok = (i >= 0) & (i < reg)
        return -logp.gather(-1, i.clamp(0, reg - 1)[..., None])[..., 0] * ok

    return (ce(tl) * wl + ce(tl + 1) * (1 - wl)).mean(-1)


def loss_sums(maps, labels, label_mask, num_classes, reg_max=16, gains=(7.5, 1.0, 2.5)):
    """(gain-weighted sum of the box, class and DFL terms, the sum of the
    target scores it is normalised by). The loss of the batch is
    ``sums / max(target sum, 1) * batch``; a batch split into chunks
    adds each chunk's two numbers."""
    box_logits, cls_logits, anchors, strides = flatten(maps, reg_max)
    img = torch.tensor([maps[0].shape[2] * 8, maps[0].shape[1] * 8] * 2, dtype=torch.float32,
                       device=maps[0].device)
    pred_dist = box_logits.reshape(box_logits.shape[:-1] + (4, reg_max))
    pred = torch.cat([anchors - dfl_expectation(box_logits, reg_max)[..., :2],
                      anchors + dfl_expectation(box_logits, reg_max)[..., 2:]], -1)
    labels = labels.float()
    gt_cls = labels[..., 0].long()
    gt_wh = labels[..., 1:] * img
    gt_boxes = xyxy(gt_wh)
    gt_mask = label_mask.bool() & (gt_wh[..., 2:].sum(-1) > 0)
    t_boxes, t_scores, fg = assign(torch.sigmoid(cls_logits.detach()),
                                   pred.detach() * strides, anchors * strides, gt_cls, gt_boxes,
                                   gt_mask)
    x = cls_logits
    bce = (x.clamp(min=0) - x * t_scores + torch.log1p(torch.exp(-x.abs()))).sum()
    t_grid = t_boxes / strides
    weight = t_scores.sum(-1) * fg
    box = ((1 - ciou(pred, t_grid)) * weight).sum()
    ltrb = torch.cat([anchors - t_grid[..., :2], t_grid[..., 2:] - anchors], -1)
    dfl = (_dfl(pred_dist, ltrb.clamp(0, reg_max - 1 - 0.01)) * weight).sum()
    return gains[0] * box + gains[1] * bce + gains[2] * dfl, t_scores.sum()
