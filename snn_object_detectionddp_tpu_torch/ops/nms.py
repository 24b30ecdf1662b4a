"""Fixed-shape non-maximum suppression, batched over images.

Candidates are top-k selected, suppression runs over a precomputed IoU
matrix (or, for large pools, greedily one IoU row at a time), and outputs
are padded to ``max_det`` with a validity mask: the
dict has ``boxes`` (B, max_det, 4), ``scores`` (B, max_det), ``classes``
(B, max_det) int32 and ``valid`` (B, max_det) bool; invalid slots have
score 0 and class -1. Ties in the top-k keep the lower index first
(stable sort), as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

import torch

from ..utils.profiling import count
from .boxes import EPS, box_area, pairwise_iou

# Class-offset used for class-aware suppression (larger than any image dim).
_CLS_OFFSET = 7680.0
# Pools up to this size use the k x k IoU matrix; larger pools take the
# greedy path, whose memory is O(k) (evaluation's 30,000-candidate pool).
_MATRIX_PATH_MAX_K = 4096
# Within the matrix path, pools up to this size iterate the whole-matrix
# map to its fixed point (2-4 sweeps in practice); larger pools run the
# k-step sequential sweep (bounded O(k^2) work).
_FIXPOINT_MAX_K = 1024


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last axis, ties broken toward the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _fixed_point(sup: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Iterate ``keep -> valid & ~any_j(sup[j, i] & keep[j])`` from
    ``valid`` to its fixed point. Eagerly a Python loop that stops when a
    sweep changes nothing; while ``torch.export`` traces, the same sweeps
    as a ``while_loop`` operator (the JAX package's ``lax.while_loop``),
    which a program can hold where a branch on a tensor's value cannot be
    traced. Both evaluate the same boolean sweeps, so their results are
    equal."""

    def sweep(keep):
        return valid & ~(sup & keep[..., :, None]).any(-2)

    if torch.compiler.is_exporting():
        from torch._higher_order_ops import while_loop

        def body(keep, changed):
            new = sweep(keep)
            return new, (new != keep).any()

        first = torch.ones((), dtype=torch.bool, device=valid.device)
        return while_loop(lambda keep, changed: changed.clone(), body, (valid.clone(), first))[0]
    keep = valid
    while True:
        new = sweep(keep)
        count("nms.sweeps")  # each sweep is a host sync (torch.equal)
        if torch.equal(new, keep):
            return keep
        keep = new


def _nms_matrix(top_boxes, top_scores, top_cls, top_valid, iou_thres, max_det):
    """Suppression over the (B, k, k) IoU matrix. The recurrence ``keep[i]
    = valid[i] and no j < i with keep[j] and iou[j, i] > thr`` (candidates
    sorted by descending score) is classic sequential NMS; iterating the
    whole-vector map to its fixed point reaches it in (chain depth + 1)
    sweeps."""
    k = top_scores.shape[-1]
    offset_boxes = top_boxes + (top_cls.to(top_boxes.dtype) * _CLS_OFFSET)[..., None]
    iou = pairwise_iou(offset_boxes, offset_boxes)  # (B, k, k)
    order = torch.arange(k, device=top_scores.device)

    if k <= _FIXPOINT_MAX_K:
        # sup[b, j, i]: candidate j (higher-scoring, valid) overlaps i.
        sup = (iou > iou_thres) & (order[:, None] < order[None, :])
        sup = sup & top_valid[..., :, None]
        keep = _fixed_point(sup, top_valid)
    else:
        keep = torch.ones_like(top_valid)
        for i in range(k):
            row_active = keep[..., i] & top_valid[..., i]
            suppress = row_active[..., None] & (iou[..., i, :] > iou_thres) & (order > i)
            keep = keep & ~suppress
        keep = keep & top_valid

    scores = torch.where(keep, top_scores, torch.zeros_like(top_scores))
    classes = torch.where(keep, top_cls, torch.full_like(top_cls, -1))
    boxes = torch.where(keep[..., None], top_boxes, torch.zeros_like(top_boxes))

    sort_scores, sort_idx = _top_k(scores, min(max_det, k))
    return {
        "boxes": torch.gather(boxes, -2, sort_idx[..., None].expand(*sort_idx.shape, 4)),
        "scores": sort_scores,
        "classes": torch.gather(classes, -1, sort_idx),
        "valid": torch.gather(keep, -1, sort_idx),
    }


def _nms_greedy(top_boxes, top_scores, top_cls, top_valid, iou_thres, max_det):
    """Greedy NMS of (B, k) candidates: ``max_det`` sequential rounds of
    (argmax score -> emit -> suppress one IoU row), every image of the
    batch advancing together. Same results as the matrix path, but memory
    is O(k) per image instead of O(k^2). A score tie goes to the lower
    index (``torch.argmax`` returns the first maximum, as ``jnp.argmax``);
    an image whose candidates are used up emits invalid slots."""
    bsz = top_scores.shape[0]
    offset_boxes = top_boxes + (top_cls.to(top_boxes.dtype) * _CLS_OFFSET)[..., None]
    scores = torch.where(top_valid, top_scores, torch.zeros_like(top_scores))
    # One IoU row a round, with pairwise_iou's arithmetic (so both paths
    # compare the same IoU values) but the candidates' corners and areas
    # taken once: a round is a handful of small launches.
    lo, hi = offset_boxes[..., :2], offset_boxes[..., 2:]
    area = box_area(offset_boxes)
    picked, picked_scores = [], []
    for _ in range(max_det):
        i = torch.argmax(scores, dim=-1, keepdim=True)  # (B, 1)
        s = scores.gather(1, i)
        box = offset_boxes.gather(1, i[..., None].expand(bsz, 1, 4))
        wh = (torch.minimum(box[..., 2:], hi) - torch.maximum(box[..., :2], lo)).clamp_(min=0.0)
        inter = wh[..., 0] * wh[..., 1]
        iou_row = inter / (area.gather(1, i) + area - inter + EPS)
        scores = scores.masked_fill((s > 0.0) & (iou_row > iou_thres), 0.0)  # includes self
        scores.scatter_(1, i, 0.0)
        picked.append(i)
        picked_scores.append(s)
    idx = torch.cat(picked, -1)  # (B, max_det)
    out_scores = torch.cat(picked_scores, -1)
    valid = out_scores > 0.0
    boxes = torch.gather(top_boxes, 1, idx[..., None].expand(bsz, max_det, 4))
    classes = torch.gather(top_cls, 1, idx)
    return {
        "boxes": torch.where(valid[..., None], boxes, torch.zeros_like(boxes)),
        "scores": torch.where(valid, out_scores, torch.zeros_like(out_scores)),
        "classes": torch.where(valid, classes, torch.full_like(classes, -1)),
        "valid": valid,
    }


def batched_nms(
    boxes_xyxy: torch.Tensor,
    class_scores: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    multi_label: bool = False,
    pre_nms_topk: int | None = None,
) -> dict[str, torch.Tensor]:
    """Fixed-shape NMS of each image of a batch.

    Args:
      boxes_xyxy: (B, A, 4) decoded boxes in pixels.
      class_scores: (B, A, nc) per-class confidences in [0, 1].
      multi_label: a box may be emitted once per class above threshold;
        otherwise the argmax class only.
      pre_nms_topk: pre-NMS candidate pool size, default 4*max_det; pools
        above 4096 candidates take the greedy path.
    """
    bsz, num_anchors, nc = class_scores.shape
    dev = class_scores.device
    if multi_label:
        flat_scores = class_scores.reshape(bsz, -1)  # (B, A*nc)
        cand_cls = torch.arange(nc, dtype=torch.int32, device=dev).repeat(num_anchors)
        cand_box_idx = torch.arange(num_anchors, device=dev).repeat_interleave(nc)
        cand_cls = cand_cls.expand(bsz, -1)
    else:
        flat_scores, cand_cls = class_scores.max(-1)  # first max, as jnp.argmax
        cand_cls = cand_cls.to(torch.int32)
        cand_box_idx = torch.arange(num_anchors, device=dev)

    masked = torch.where(flat_scores >= conf_thres, flat_scores,
                         torch.full_like(flat_scores, -1.0))
    if pre_nms_topk is None:
        pre_nms_topk = 4 * max_det
    k = min(pre_nms_topk, masked.shape[-1])
    top_scores, top_idx = _top_k(masked, k)
    top_cls = torch.gather(cand_cls, -1, top_idx)
    box_idx = cand_box_idx[top_idx]  # (B, k)
    top_boxes = torch.gather(boxes_xyxy, 1, box_idx[..., None].expand(bsz, k, 4))
    top_valid = top_scores > 0.0

    nms_fn = _nms_matrix if k <= _MATRIX_PATH_MAX_K else _nms_greedy
    out = nms_fn(top_boxes, top_scores, top_cls, top_valid, iou_thres, max_det)

    pad = max_det - out["scores"].shape[-1]
    if pad > 0:
        out = {
            "boxes": torch.nn.functional.pad(out["boxes"], (0, 0, 0, pad)),
            "scores": torch.nn.functional.pad(out["scores"], (0, pad)),
            "classes": torch.nn.functional.pad(out["classes"], (0, pad), value=-1),
            "valid": torch.nn.functional.pad(out["valid"], (0, pad)),
        }
    return out


def non_max_suppression(boxes_xyxy: torch.Tensor, class_scores: torch.Tensor,
                        **kwargs) -> dict[str, torch.Tensor]:
    """Single-image NMS: (A, 4), (A, nc) -> the dict without a batch axis."""
    out = batched_nms(boxes_xyxy[None], class_scores[None], **kwargs)
    return {k: v[0] for k, v in out.items()}
