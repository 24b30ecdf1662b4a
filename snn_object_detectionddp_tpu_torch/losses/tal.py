"""Task-Aligned Assigner (TAL), fixed-shape and fully masked.

Ground truth arrives padded to (B, M, ...) with a validity mask, and every
intermediate is a dense (B, M, A) tensor (no ragged boolean indexing).

Alignment metric: score(gt_class)^alpha * IoU(gt, pred)^beta with
alpha=0.5, beta=6.0, top-k=10 candidate anchors per gt restricted to anchors
whose center lies inside the gt box; anchors claimed by multiple gts resolve
to the gt with the highest IoU.

Parity with the JAX package's assigner, which this module is held against:
one-hots are built by comparison or gather, so a class index out of range
gives a zero row (``jax.nn.one_hot``) instead of raising
(``F.one_hot``); the top-k is a stable descending sort, so ties keep the
lower anchor index first (``jax.lax.top_k``); ``argmax`` returns the first
maximum in both frameworks. The assignment is label construction, not a
differentiable path: callers pass detached inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.boxes import ciou

ALPHA = 0.5
BETA = 6.0
TOPK = 10
EPS = 1e-9


class AssignResult(NamedTuple):
    target_labels: torch.Tensor  # (B, A) int32
    target_bboxes: torch.Tensor  # (B, A, 4) xyxy pixels
    target_scores: torch.Tensor  # (B, A, nc) soft targets in [0, 1]
    fg_mask: torch.Tensor  # (B, A) bool


def _candidates_in_gts(
    anc_points: torch.Tensor, gt_bboxes: torch.Tensor, eps: float = 1e-9
) -> torch.Tensor:
    """(A, 2) anchor centers x (B, M, 4) gt xyxy -> (B, M, A) bool."""
    x, y = anc_points[:, 0], anc_points[:, 1]
    x1, y1, x2, y2 = (gt_bboxes[..., i][..., None] for i in range(4))
    return (x - x1 > eps) & (y - y1 > eps) & (x2 - x > eps) & (y2 - y > eps)


def _topk_mask(metric: torch.Tensor, k: int) -> torch.Tensor:
    """Per-(B, M) row, a bool mask of the top-k entries along A with
    positive metric. (B, M, A) -> (B, M, A)."""
    k = min(k, metric.shape[-1])
    vals, idx = torch.sort(metric, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    mask = torch.zeros_like(metric, dtype=torch.bool)
    return mask.scatter_(-1, idx, vals > EPS)


def _one_hot(index: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """(...,) integer -> (..., n) one-hot; an index outside [0, n) gives a
    zero row."""
    return (index[..., None] == torch.arange(n, device=index.device)).to(dtype)


def task_aligned_assign(
    pd_scores: torch.Tensor,  # (B, A, nc) sigmoid class probs
    pd_bboxes: torch.Tensor,  # (B, A, 4) xyxy pixels
    anc_points: torch.Tensor,  # (A, 2) pixels
    gt_labels: torch.Tensor,  # (B, M) integer
    gt_bboxes: torch.Tensor,  # (B, M, 4) xyxy pixels
    mask_gt: torch.Tensor,  # (B, M) bool
    topk: int = TOPK,
    alpha: float = ALPHA,
    beta: float = BETA,
) -> AssignResult:
    b, a, nc = pd_scores.shape
    m = gt_labels.shape[1]
    gt_labels = gt_labels.long()

    # --- Candidate mask & alignment metric -------------------------------
    mask_in_gts = _candidates_in_gts(anc_points, gt_bboxes)  # (B, M, A)
    # Alignment overlap is CIoU clamped at 0 (ultralytics convention).
    overlaps = ciou(gt_bboxes[..., :, None, :], pd_bboxes[..., None, :, :]).clamp(min=0.0)

    # Class score of each gt's class at every anchor: (B, M, A).
    in_range = (gt_labels >= 0) & (gt_labels < nc)
    label_idx = gt_labels.clamp(0, nc - 1)[..., None].expand(b, m, a)
    cls_score = pd_scores.transpose(1, 2).gather(1, label_idx) * in_range[..., None]

    valid = mask_in_gts & mask_gt[..., None]
    align = torch.where(
        valid, cls_score.pow(alpha) * overlaps.pow(beta), torch.zeros_like(overlaps)
    )

    # --- Top-k per gt, then resolve multi-assignment by IoU --------------
    mask_pos = _topk_mask(align, topk) & valid  # (B, M, A)
    fg_mask = mask_pos.sum(1) > 0  # (B, A)

    # Anchor claimed by >1 gt -> keep the gt with max IoU (applied
    # unconditionally: a no-op for singly-assigned anchors).
    masked_overlaps = torch.where(mask_pos, overlaps, torch.full_like(overlaps, -1.0))
    target_gt_idx = masked_overlaps.argmax(1)  # (B, A)
    resolved = target_gt_idx[:, None, :] == torch.arange(m, device=gt_labels.device)[None, :, None]
    mask_pos = mask_pos & resolved

    # --- Gather per-anchor targets ---------------------------------------
    target_labels = gt_labels.gather(1, target_gt_idx)  # (B, A)
    target_bboxes = gt_bboxes.gather(1, target_gt_idx[..., None].expand(b, a, 4))
    target_labels = torch.where(fg_mask, target_labels, torch.zeros_like(target_labels))
    target_scores = _one_hot(target_labels, nc, pd_scores.dtype) * fg_mask[..., None]

    # --- Normalize soft targets by per-gt peak alignment ------------------
    zeros = torch.zeros_like(align)
    align = torch.where(mask_pos, align, zeros)
    pos_align = align.amax(-1, keepdim=True)  # (B, M, 1)
    pos_overlap = torch.where(mask_pos, overlaps, zeros).amax(-1, keepdim=True)
    norm_align = (align * pos_overlap / (pos_align + EPS)).amax(1)  # (B, A)
    target_scores = target_scores * norm_align[..., None]

    return AssignResult(
        target_labels=target_labels.to(torch.int32),
        target_bboxes=target_bboxes,
        target_scores=target_scores,
        fg_mask=fg_mask,
    )
