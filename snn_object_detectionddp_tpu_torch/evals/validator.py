"""Model mAP evaluation: the recurrent forward over each window, NMS with
conf=0.001 / iou=0.6 / max_det=300 over a 30,000-candidate pool, and the
predictions and targets fed to :class:`~.map.DetMetrics`.

Forward, decode and NMS run on the detector's device (the card unless the
caller built the detector for the CPU); only the metric accumulation is
host numpy, overlapped with the next batch's device work by a
one-batch-delayed fetch.

:func:`evaluate_batches` takes the batches from the caller;
:func:`evaluate_model` reads the seeded validation split of the DSEC
directory a config names through the data pipeline (``data/``).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from ..data.dsec import DSECIndex, train_val_split
from ..data.encoding import preprocess_video
from ..data.pipeline import BatchLoader
from ..models.detect import decode_predictions
from ..ops.nms import batched_nms
from ..train.loop import _progress
from ..utils.pipelining import DelayedFetch
from .map import DetMetrics

EVAL_CONF = 0.001
EVAL_IOU = 0.6
EVAL_MAX_DET = 300
# Pre-NMS candidate pool at eval thresholds: ultralytics keeps up to 30k
# boxes before NMS (non_max_suppression max_nms); matching it keeps the
# low-confidence tail that mAP at conf=0.001 depends on.
EVAL_PRE_NMS_TOPK = 30000


def make_predict_fn(detector, conf=EVAL_CONF, iou=EVAL_IOU, max_det=EVAL_MAX_DET,
                    multi_label=False, pre_nms_topk=EVAL_PRE_NMS_TOPK, mesh=None):
    """(params, images_u8 (B, T, H, W, 3)) -> fixed-shape NMS dict of tensors
    on the detector's device, computed without a gradient. ``images_u8`` is
    a uint8 numpy array or tensor; ``params`` must already be on the
    detector's device."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded evaluation is not ported yet; evaluate on one device (mesh=None)"
        )
    reg_max = detector.cfg.model.hyp.reg_max
    nc = detector.cfg.model.num_classes

    @torch.no_grad()
    def predict(params, images_u8):
        images = torch.as_tensor(images_u8).to(detector.device)
        frames = preprocess_video(images, dtype=detector.dtype)
        raw_maps, _ = detector.apply(params, frames)
        boxes, scores = decode_predictions(
            raw_maps, reg_max, nc, image_hw=tuple(images.shape[2:4])
        )
        return batched_nms(
            boxes, scores, conf_thres=conf, iou_thres=iou, max_det=max_det,
            multi_label=multi_label, pre_nms_topk=pre_nms_topk,
        )

    return predict


def _cxcywh_to_xyxy(b: np.ndarray) -> np.ndarray:
    cx, cy, w, h = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    return np.stack([cx - w / 2.0, cy - h / 2.0, cx + w / 2.0, cy + h / 2.0], -1)


def evaluate_batches(detector, params, batches: Iterable[dict], predict=None,
                     mesh=None) -> dict:
    """Evaluate over ``batches`` and return the results dict (precision,
    recall, mAP50, mAP50-95, fitness). Each batch is a dict of numpy arrays:
    ``images`` (B, T, H, W, 3) uint8, ``labels`` (B, max_boxes, 5)
    [class, cx, cy, w, h] normalized, ``label_mask`` (B, max_boxes) bool and
    ``paths`` — one entry per real sample, so rows a loader padded the batch
    with never reach the metrics. ``predict`` defaults to
    :func:`make_predict_fn` at the evaluation thresholds."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded evaluation is not ported yet; evaluate on one device (mesh=None)"
        )
    if predict is None:
        predict = make_predict_fn(detector)
    metrics = DetMetrics(detector.cfg.model.num_classes)

    def accumulate(out_dev, batch):
        out = {k: v.cpu().numpy() for k, v in out_dev.items()}
        h, w = batch["images"].shape[2:4]
        scale = np.array([w, h, w, h], np.float32)
        for i in range(len(batch["paths"])):  # real samples only
            valid = out["valid"][i]
            gt = batch["labels"][i][batch["label_mask"][i]]
            gt_boxes = _cxcywh_to_xyxy(gt[:, 1:] * scale) if gt.size else np.zeros((0, 4))
            metrics.update(
                pred_boxes=out["boxes"][i][valid],
                pred_conf=out["scores"][i][valid],
                pred_cls=out["classes"][i][valid],
                gt_boxes=gt_boxes,
                gt_cls=gt[:, 0] if gt.size else np.zeros(0),
            )

    # One-batch-delayed fetch: batch k's copy to the host and metric
    # accumulation run while the device computes batch k+1.
    fetch = DelayedFetch(accumulate)
    for batch in batches:
        fetch.push(predict(params, batch["images"]), batch)
    fetch.flush()
    return metrics.results_dict()


def evaluate_model(cfg, detector, params, batch_size: int | None = None, mesh=None) -> dict:
    """Evaluate over the seeded validation split of the DSEC directory that
    ``cfg.dataset.train`` names (the JAX package's ``evaluate_model``): the
    same sequence split as training, a loader without shuffling whose
    padded last-batch rows never reach the metrics, and the results dict,
    printed and returned. ``params`` must be on the detector's device."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded evaluation is not ported yet; evaluate on one device (mesh=None)"
        )
    index = DSECIndex(cfg, "train")
    _, val_idx = train_val_split(index, seed=cfg.training.seed)
    loader = BatchLoader(
        index, val_idx, batch_size=batch_size or cfg.training.batch_size,
        max_boxes=cfg.model.max_boxes, shuffle=False, num_threads=cfg.training.num_workers,
    )
    results = evaluate_batches(detector, params, _progress(loader, "Evaluating", len(loader)))
    print("\n--- Evaluation Results ---")
    for k, v in results.items():
        print(f"{k}: {v:.5f}")
    return results
