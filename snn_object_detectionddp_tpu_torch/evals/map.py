"""Detector quality metrics: mAP50 / mAP50-95 / precision / recall.

Host-side numpy, fed with the NMS outputs after they have left the card.
Matching and AP follow the ultralytics ``DetMetrics`` conventions so the
numbers are comparable with other YOLO-family evaluations:

- per image, per IoU threshold (0.50:0.95:0.05): predictions match gts of
  the same class greedily by IoU, one gt per prediction;
- AP via 101-point interpolated precision envelope;
- P and R reported at the max-F1 confidence point of the IoU=0.50 curve;
- fitness = 0.1 * mAP50 + 0.9 * mAP50-95.
"""

from __future__ import annotations

import numpy as np

IOU_THRESHOLDS = np.round(np.arange(0.5, 0.96, 0.05), 2)  # 10 thresholds
# numpy 2 renamed trapz to trapezoid; either may be the one installed.
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy -> (N, M)."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / (union + 1e-9)


def match_predictions(
    pred_boxes: np.ndarray,  # (P, 4) xyxy
    pred_cls: np.ndarray,  # (P,)
    gt_boxes: np.ndarray,  # (G, 4) xyxy
    gt_cls: np.ndarray,  # (G,)
    thresholds: np.ndarray = IOU_THRESHOLDS,
) -> np.ndarray:
    """True-positive flags per prediction per IoU threshold -> (P, T) bool."""
    p, t = pred_boxes.shape[0], len(thresholds)
    correct = np.zeros((p, t), bool)
    if p == 0 or gt_boxes.shape[0] == 0:
        return correct
    iou = _iou_matrix(gt_boxes, pred_boxes)  # (G, P)
    same_cls = gt_cls[:, None] == pred_cls[None, :]
    iou = np.where(same_cls, iou, 0.0)
    for ti, thr in enumerate(thresholds):
        g_idx, p_idx = np.nonzero(iou >= thr)
        if g_idx.size == 0:
            continue
        vals = iou[g_idx, p_idx]
        order = vals.argsort()[::-1]
        g_idx, p_idx = g_idx[order], p_idx[order]
        # unique prediction, then unique gt (ultralytics match order)
        keep = np.unique(p_idx, return_index=True)[1]
        g_idx, p_idx = g_idx[np.sort(keep)], p_idx[np.sort(keep)]
        keep = np.unique(g_idx, return_index=True)[1]
        g_idx, p_idx = g_idx[np.sort(keep)], p_idx[np.sort(keep)]
        correct[p_idx, ti] = True
    return correct


def _compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """101-point interpolated AP from raw PR points.

    The closing sentinel sits at ``recall[-1] + 0.01`` (ultralytics
    convention), NOT at 1.0 — a sentinel at 1.0 collides with attained
    recall when the last prediction is a TP and clips perfect detections
    to AP 0.995."""
    mrec = np.concatenate(([0.0], recall, [recall[-1] + 0.01] if recall.size else [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    return float(_trapezoid(np.interp(x, mrec, mpre), x))


def ap_per_class(
    tp: np.ndarray,  # (P, T) bool over all images
    conf: np.ndarray,  # (P,)
    pred_cls: np.ndarray,  # (P,)
    target_cls: np.ndarray,  # (G,) over all images
    num_classes: int,
) -> dict:
    """Aggregate AP/precision/recall per class.

    Returns dict with ap (C, T), p (C,), r (C,), present (C,) bool.
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]

    t = tp.shape[1] if tp.size else len(IOU_THRESHOLDS)
    ap = np.zeros((num_classes, t))
    p_out = np.zeros(num_classes)
    r_out = np.zeros(num_classes)
    present = np.zeros(num_classes, bool)

    for c in range(num_classes):
        n_gt = int((target_cls == c).sum())
        sel = pred_cls == c
        n_p = int(sel.sum())
        if n_gt == 0:
            continue
        present[c] = True
        if n_p == 0:
            continue
        tpc = tp[sel].cumsum(axis=0)  # (n_p, T)
        fpc = (~tp[sel]).cumsum(axis=0)
        recall = tpc / (n_gt + 1e-9)
        precision = tpc / (tpc + fpc + 1e-9)
        for ti in range(t):
            ap[c, ti] = _compute_ap(recall[:, ti], precision[:, ti])
        # P/R at max-F1 confidence on the IoU=0.5 curve.
        f1 = 2 * precision[:, 0] * recall[:, 0] / (
            precision[:, 0] + recall[:, 0] + 1e-9
        )
        i = int(np.argmax(f1))
        p_out[c] = precision[i, 0]
        r_out[c] = recall[i, 0]

    return {"ap": ap, "p": p_out, "r": r_out, "present": present}


class DetMetrics:
    """Accumulator with ultralytics DetMetrics' results_dict schema."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self._tp: list[np.ndarray] = []
        self._conf: list[np.ndarray] = []
        self._pred_cls: list[np.ndarray] = []
        self._target_cls: list[np.ndarray] = []

    def update(
        self,
        pred_boxes: np.ndarray,
        pred_conf: np.ndarray,
        pred_cls: np.ndarray,
        gt_boxes: np.ndarray,
        gt_cls: np.ndarray,
    ) -> None:
        """One image's detections (pixels, xyxy) + ground truth."""
        tp = match_predictions(pred_boxes, pred_cls, gt_boxes, gt_cls)
        self._tp.append(tp)
        self._conf.append(pred_conf)
        self._pred_cls.append(pred_cls)
        self._target_cls.append(gt_cls)

    def compute(self) -> dict:
        tp = (
            np.concatenate(self._tp)
            if self._tp
            else np.zeros((0, len(IOU_THRESHOLDS)), bool)
        )
        conf = np.concatenate(self._conf) if self._conf else np.zeros(0)
        pred_cls = np.concatenate(self._pred_cls) if self._pred_cls else np.zeros(0)
        target_cls = (
            np.concatenate(self._target_cls) if self._target_cls else np.zeros(0)
        )
        res = ap_per_class(tp, conf, pred_cls, target_cls, self.num_classes)
        present = res["present"]
        if present.any():
            map50 = float(res["ap"][present, 0].mean())
            map5095 = float(res["ap"][present].mean())
            mp = float(res["p"][present].mean())
            mr = float(res["r"][present].mean())
        else:
            map50 = map5095 = mp = mr = 0.0
        return {
            "metrics/precision(B)": mp,
            "metrics/recall(B)": mr,
            "metrics/mAP50(B)": map50,
            "metrics/mAP50-95(B)": map5095,
            "fitness": 0.1 * map50 + 0.9 * map5095,
        }

    # name parity with ultralytics
    def results_dict(self) -> dict:
        return self.compute()
