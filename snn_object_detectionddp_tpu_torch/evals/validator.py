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

With a data mesh (parallel/mesh.py) every process predicts its own
contiguous, unpadded share of the validation windows, and the per-image
records (boxes, scores, classes, ground truth) are gathered to rank 0 in
validation-index order before they reach ``DetMetrics``: the results equal
one process's exactly (the metric's confidence sort breaks ties by order,
so the order is kept). Rank 0 alone computes the metric and sends the
results dict to the other ranks.

With a ``data x tensor`` mesh the processes of one tensor group share
each batch: every layer runs on their channel shards of the parameters
(``tp_shard_params``), the full raw maps come out on each of them, and the
data axis splits the windows as above. With a ``data x spatial`` mesh the
processes of one spatial group share each batch by rows: each
preprocesses and runs its rows of the images, the whole raw maps come out
on each of them, and NMS runs on them whole.
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
from ..parallel.mesh import (
    broadcast_from_main,
    eval_shard,
    gather_to_main,
    is_main_process,
    local_batch_size,
    pad_batch_to_devices,
    spatial_rows,
    tp_shard_params,
)
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
    detector's device. Under a data mesh each process predicts its own
    batches with the whole model. With a ``mesh`` that has a tensor axis,
    ``params`` are this rank's shards (``tp_shard_params(params, mesh)``),
    the processes of a tensor group call it together on the same images
    and each gets the whole result; with a spatial axis the processes of a
    spatial group do, each running its rows of them."""
    reg_max = detector.cfg.model.hyp.reg_max
    nc = detector.cfg.model.num_classes

    @torch.no_grad()
    def predict(params, images_u8):
        images = torch.as_tensor(images_u8)
        frames = preprocess_video(spatial_rows(images, mesh).to(detector.device),
                                  dtype=detector.dtype)
        raw_maps, _ = detector.apply(params, frames, mesh=mesh, height=images.shape[2])
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
    :func:`make_predict_fn` at the evaluation thresholds.

    ``mesh``: a data mesh; ``batches`` are then this process's share, in
    order. The records are gathered to rank 0 in rank order, rank 0
    computes the results over all processes' images, and every process
    returns them. With a tensor axis ``params`` are this rank's shards and
    every data rank's records are gathered within each tensor rank's data
    group alike."""
    if predict is None:
        predict = make_predict_fn(detector, mesh=mesh)
    records = []  # one metric update per real sample, in batch order

    def accumulate(out_dev, batch):
        out = {k: v.cpu().numpy() for k, v in out_dev.items()}
        h, w = batch["images"].shape[2:4]
        scale = np.array([w, h, w, h], np.float32)
        for i in range(len(batch["paths"])):  # real samples only
            valid = out["valid"][i]
            gt = batch["labels"][i][batch["label_mask"][i]]
            gt_boxes = _cxcywh_to_xyxy(gt[:, 1:] * scale) if gt.size else np.zeros((0, 4))
            records.append(dict(
                pred_boxes=out["boxes"][i][valid],
                pred_conf=out["scores"][i][valid],
                pred_cls=out["classes"][i][valid],
                gt_boxes=gt_boxes,
                gt_cls=gt[:, 0] if gt.size else np.zeros(0),
            ))

    # One-batch-delayed fetch: batch k's copy to the host runs while the
    # device computes batch k+1.
    fetch = DelayedFetch(accumulate)
    for batch in batches:
        fetch.push(predict(params, batch["images"]), batch)
    fetch.flush()
    everyone = gather_to_main(records, mesh)
    results = None
    if everyone is not None:  # rank 0, or no mesh
        metrics = DetMetrics(detector.cfg.model.num_classes)
        for rec in everyone:
            metrics.update(**rec)
        results = metrics.results_dict()
    return broadcast_from_main(results, mesh)


def evaluate_model(cfg, detector, params, batch_size: int | None = None, mesh=None) -> dict:
    """Evaluate over the seeded validation split of the DSEC directory that
    ``cfg.dataset.train`` names (the JAX package's ``evaluate_model``): the
    same sequence split as training, a loader without shuffling whose
    padded last-batch rows never reach the metrics, and the results dict,
    printed and returned. ``params`` must be on the detector's device.

    ``mesh``: a ``data x tensor`` or ``data x spatial`` mesh. The global
    batch (``batch_size``, rounded up to a multiple of the data axis) is
    split over the data axis, each tensor (spatial) group predicts its
    contiguous share of the windows without padding on its channel shards
    of the (whole) ``params`` (its rows of the images), and every process
    returns the results over all windows; rank 0 prints them."""
    index = DSECIndex(cfg, "train")
    _, val_idx = train_val_split(index, seed=cfg.training.seed)
    bs = batch_size or cfg.training.batch_size
    if mesh is not None:
        bs = local_batch_size(pad_batch_to_devices(bs, mesh.size), mesh.size)
    if mesh is not None:
        params = tp_shard_params(params, mesh)
    loader = BatchLoader(
        index, eval_shard(val_idx, mesh), batch_size=bs,
        max_boxes=cfg.model.max_boxes, shuffle=False, num_threads=cfg.training.num_workers,
    )
    results = evaluate_batches(detector, params, _progress(loader, "Evaluating", len(loader)),
                               mesh=mesh)
    if is_main_process():
        print("\n--- Evaluation Results ---")
        for k, v in results.items():
            print(f"{k}: {v:.5f}")
    return results
