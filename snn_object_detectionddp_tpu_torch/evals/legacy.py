"""Tracker benchmark: the detector every N frames plus optical-flow
propagation between them, with FPS and FLOPs per frame.

The port's counterpart of the JAX package's ``evals/legacy.py``, with the
spiking detector in streaming mode (T=1, recurrent state carried from
frame to frame) on the detector's device:

- method "entire_model": detect every frame;
- method "cropped_model": detect every frame, inside a fixed-size crop
  window (half the frame, 32-aligned) centered on the current track boxes,
  stateless, or on the whole frame while there are no tracks;
- method "optical_flow": detect every ``stride`` frames (or as an
  adaptive-stride hook schedules), shift the boxes by the flow in between;
- FPS including and excluding frame retrieval (each timed segment ends in
  a device-to-host copy, so the compute time holds the card's work);
- blended FLOPs per frame = (flow FLOPs + detections x model FLOPs) /
  frames, the model's counted by ``utils/profiling.flops_of`` once per
  geometry (the convs and matmuls only: see its docstring);
- quality when the test split has ``tracks.npy``: average best IoU per
  detection and precision at IoU 0.5, and the mean ground-truth speed.

Frames are read by ``data/png.py::read_rgb`` and kept in BGR, the order
the JAX package reads them in (its flow and drawing see BGR, its model
RGB). The annotate path draws with ``data/raster.py`` and writes with
``write_rgb``; the flow is evals/flow.py's. No OpenCV.
"""

from __future__ import annotations

import time
import weakref
from pathlib import Path

import numpy as np
import torch

from ..data.dsec import DSECIndex
from ..data.encoding import preprocess_video
from ..data.png import read_rgb, write_rgb
from ..data.raster import rectangle
from ..models.detect import decode_predictions
from ..ops.nms import batched_nms
from ..utils.profiling import flops_of
from .flow import flow_flops_per_frame, get_optical_flow, update_bounding_boxes
from .map import _iou_matrix

TRACK_MAX_DET = 100
ANNOTATE_COLOR = (0, 255, 0)  # BGR green


def eval_metric_dsec(
    detections: list[np.ndarray], gts: list[np.ndarray], iou_thresh: float = 0.5
) -> dict:
    """Average best IoU per detection and precision at ``iou_thresh``: each
    detection is scored by its best-overlapping ground-truth box of the
    frame (0 where the frame has none)."""
    ious: list[float] = []
    for det, gt in zip(detections, gts):
        if det.size == 0:
            continue
        if gt.size == 0:
            ious.extend([0.0] * len(det))
            continue
        m = _iou_matrix(det[:, :4], gt[:, :4])
        ious.extend(m.max(axis=1).tolist())
    if not ious:
        return {"avg_iou": 0.0, "precision": 0.0, "num_detections": 0}
    arr = np.asarray(ious)
    return {
        "avg_iou": float(arr.mean()),
        "precision": float((arr >= iou_thresh).mean()),
        "num_detections": int(arr.size),
    }


# FLOPs of a step program per (module, kind, geometry): like the JAX
# package's compile cache, counted once, since they depend on shapes only.
_FLOPS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def model_flops(detector, kind: str, fn, *example_args) -> float:
    """FLOPs of one call of a step program (``kind``: "stream" or "crop"),
    counted by ``flops_of`` on the first call for the detector's module and
    the example's geometry, then cached; the counting call runs the program
    once."""
    per_module = _FLOPS.setdefault(detector.module, {})
    key = (kind, tuple(example_args[0].shape), len(example_args) > 1 and example_args[1] is None)
    if key not in per_module:
        per_module[key] = flops_of(fn, *example_args)
    return per_module[key]


def _crop_hw(h_img: int, w_img: int) -> tuple[int, int]:
    """Crop window of the cropped_model method: half the frame, rounded up
    to a multiple of 32, clamped to the frame."""
    ch = min(h_img, -(-(h_img // 2) // 32) * 32)
    cw = min(w_img, -(-(w_img // 2) // 32) * 32)
    return ch, cw


def default_adaptive_stride(
    prev_iou: float,
    curr_iou: float,
    stride: int,
    lo: float = 0.4,
    hi: float = 0.7,
    max_stride: int = 10,
) -> int:
    """Adaptive-stride policy for the ``compute_stride`` hook: tracking
    holding up (curr IoU >= hi) lengthens the detector interval by one (up
    to ``max_stride``), degrading (curr IoU < lo) halves it, else keep."""
    if curr_iou >= hi:
        return min(stride + 1, max_stride)
    if curr_iou < lo:
        return max(stride // 2, 1)
    return stride


def make_track_fns(detector, params, conf: float = 0.3, iou: float = 0.45):
    """The benchmark's two step programs on the detector's device:
    ``predict(image_u8 (1, H, W, 3) RGB, rec_state) -> (NMS dict on the
    device, new state)``, the T=1 streaming step; ``predict_crop(crop_u8)
    -> NMS dict``, stateless. NMS keeps at most 100 boxes."""
    reg_max = detector.cfg.model.hyp.reg_max
    nc = detector.cfg.model.num_classes

    def predict(image_u8, rec_state):
        images = torch.as_tensor(np.ascontiguousarray(image_u8)).to(detector.device)
        frames = preprocess_video(images[:, None], dtype=detector.dtype)  # (1, B=1, H, W, 3)
        raw, new_state = detector.apply(params, frames, rec_state)
        boxes, scores = decode_predictions(raw, reg_max, nc, image_hw=tuple(images.shape[1:3]))
        out = batched_nms(boxes, scores, conf_thres=conf, iou_thres=iou, max_det=TRACK_MAX_DET)
        return out, new_state

    def predict_crop(crop_u8):
        # The recurrent state belongs to the full-frame geometry.
        return predict(crop_u8, None)[0]

    return predict, predict_crop


def _host(out: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items()}


def process_sequence(
    detector,
    params,
    frame_paths: list[str],
    method: str = "optical_flow",
    stride: int = 5,
    conf: float = 0.3,
    iou: float = 0.45,
    flow_method: str = "farneback",
    flow_downsample: float = 0.5,
    annotate_dir: str | None = None,
    compute_stride=None,
    gt_boxes: list[np.ndarray] | None = None,
) -> dict:
    """Run one sequence; returns its detections and timing / FLOPs stats.

    ``gt_boxes``: optional per-frame (N, 4) xyxy pixel ground truth aligned
    with ``frame_paths``; the stats then hold the quality metrics and the
    mean ground-truth box speed.

    ``compute_stride``: optional hook ``(prev_iou, curr_iou, stride) ->
    new stride``. After each detector frame the IoU between the
    flow-propagated boxes and the fresh detections goes to the hook, whose
    stride schedules the next detector frame; the strides visited are
    ``stride_list``. ``None`` keeps ``stride``. The flow (Farneback or the
    learned one) runs on the detector's device."""
    predict, predict_crop = make_track_fns(detector, params, conf, iou)

    detections: list[np.ndarray] = []
    retrieval_time = 0.0
    compute_time = 0.0
    det_count = 0
    crop_det_count = 0  # the detector frames that ran the cropped program
    flow_count = 0
    rec_state = None
    prev_frame = None
    boxes = np.zeros((0, 4), np.float32)
    adaptive = compute_stride is not None
    cur_stride = max(1, int(stride))
    stride_list = [cur_stride]
    next_det_idx = 0
    prev_iou = 1.0  # tracking starts "fine"

    t_total0 = time.perf_counter()
    for f_idx, path in enumerate(frame_paths):
        t0 = time.perf_counter()
        rgb = read_rgb(path)
        retrieval_time += time.perf_counter() - t0
        frame = rgb[..., ::-1]  # BGR, as the JAX package reads frames

        t0 = time.perf_counter()
        cropped_now = method == "cropped_model" and boxes.size > 0
        detect_now = not cropped_now and (
            method in ("entire_model", "cropped_model")
            or (f_idx >= next_det_idx if adaptive else f_idx % stride == 0)
        )
        if cropped_now:
            # A fixed-size window centered on the union of the tracks.
            h_img, w_img = frame.shape[:2]
            ch, cw = _crop_hw(h_img, w_img)
            ux = (boxes[:, 0].min() + boxes[:, 2].max()) / 2
            uy = (boxes[:, 1].min() + boxes[:, 3].max()) / 2
            cx = int(np.clip(ux - cw / 2, 0, w_img - cw))
            cy = int(np.clip(uy - ch / 2, 0, h_img - ch))
            out = _host(predict_crop(rgb[None, cy: cy + ch, cx: cx + cw]))
            valid = out["valid"][0]
            boxes = out["boxes"][0][valid] + np.array([cx, cy, cx, cy], np.float32)
            det_count += 1
            crop_det_count += 1
        elif detect_now:
            prev_boxes = boxes  # the flow-propagated boxes before the refresh
            out, rec_state = predict(rgb[None], rec_state)
            out = _host(out)
            valid = out["valid"][0]
            boxes = out["boxes"][0][valid]
            det_count += 1
            if adaptive and method != "entire_model":
                # The first detection has tracked nothing yet, and two empty
                # box sets mean nothing to track: keep the previous IoU
                # rather than read 0 as degrading.
                if f_idx == 0 or (prev_boxes.size == 0 and boxes.size == 0):
                    curr_iou = prev_iou
                else:
                    curr_iou = compute_iou_list(prev_boxes, boxes)
                cur_stride = max(1, int(compute_stride(prev_iou, curr_iou, cur_stride)))
                stride_list.append(cur_stride)
                prev_iou = curr_iou
                next_det_idx = f_idx + cur_stride
        else:
            flow = get_optical_flow(prev_frame, frame, flow_method, flow_downsample,
                                    device=detector.device)
            boxes = update_bounding_boxes(boxes, flow)
            flow_count += 1
        compute_time += time.perf_counter() - t0

        detections.append(boxes.copy())
        prev_frame = frame
        if annotate_dir:
            img = frame.copy()
            for x1, y1, x2, y2 in boxes[:, :4]:
                rectangle(img, (int(x1), int(y1)), (int(x2), int(y2)), ANNOTATE_COLOR, 2)
            Path(annotate_dir).mkdir(parents=True, exist_ok=True)
            write_rgb(Path(annotate_dir) / Path(path).name, img[..., ::-1])

    total_time = time.perf_counter() - t_total0
    n = len(frame_paths)

    # All frames of a sequence share one geometry: one count per program.
    # A cropped call is charged the cropped program's FLOPs.
    m_flops = 0.0
    m_flops_crop = 0.0
    if n:
        h_img, w_img = prev_frame.shape[:2]
        m_flops = model_flops(detector, "stream", predict,
                              np.zeros((1, h_img, w_img, 3), np.uint8), rec_state)
        if crop_det_count:
            ch, cw = _crop_hw(h_img, w_img)
            m_flops_crop = model_flops(detector, "crop", predict_crop,
                                       np.zeros((1, ch, cw, 3), np.uint8))
    flow_flops = (
        flow_count * flow_flops_per_frame(flow_method, prev_frame.shape[0], prev_frame.shape[1],
                                          flow_downsample, device=detector.device)
        if flow_count
        else 0.0
    )
    det_flops = (det_count - crop_det_count) * m_flops + crop_det_count * m_flops_crop
    blended = (flow_flops + det_flops) / max(det_count + flow_count, 1) if n else 0.0

    stats = {
        "detections": detections,
        "num_frames": n,
        "fps_incl_retrieval": n / max(total_time, 1e-9),
        "fps_excl_retrieval": n / max(compute_time, 1e-9),
        "retrieval_time_s": retrieval_time,
        "compute_time_s": compute_time,
        "model_flops": m_flops,
        "flow_flops": flow_flops,
        "blended_flops_per_frame": blended,
        "det_count": det_count,
        "crop_det_count": crop_det_count,
        "flow_count": flow_count,
        "stride_list": stride_list,
    }
    if gt_boxes is not None:
        stats.update(eval_metric_dsec(detections, gt_boxes))
        vel = gt_velocity(gt_boxes)
        stats["gt_velocity_px_s"] = float(np.mean(vel)) if vel else 0.0
    return stats


def process_dataset(
    cfg,
    detector,
    params,
    method: str = "optical_flow",
    stride: int = 5,
    max_frames_per_seq: int | None = None,
    annotate: bool = False,
    compute_stride=None,
) -> dict:
    """Benchmark every sequence of the test split; returns per-sequence and
    aggregate stats."""
    index = DSECIndex(cfg, "test")
    # All frames of each sequence, in order (its windows share the names).
    seq_frames: dict[str, list[str]] = {}
    for s in index.samples:
        if s.image_dir not in seq_frames:
            seq_frames[s.image_dir] = [str(Path(s.image_dir) / n) for n in s.filenames]

    results = {}
    for seq_dir, paths in seq_frames.items():
        if max_frames_per_seq:
            paths = paths[:max_frames_per_seq]
        # <seq>/images/left/distorted: the sequence's name is 3 levels up.
        seq_name = Path(seq_dir).parents[2].name
        annotate_dir = (
            str(Path(cfg.training.save_dir) / "annotated" / seq_name) if annotate else None
        )
        # Per-frame xyxy ground truth where the test split has tracks.npy.
        gt_boxes = None
        per_frame = index.labels.get(seq_dir)
        if per_frame is not None:
            gt_boxes = [_gt_frame_xyxy(per_frame, i) for i in range(len(paths))]
        stats = process_sequence(
            detector, params, paths, method=method, stride=stride,
            annotate_dir=annotate_dir, compute_stride=compute_stride, gt_boxes=gt_boxes,
        )
        results[seq_dir] = stats
        line = (
            f"[{Path(seq_dir).parts[-4]}] frames={stats['num_frames']} "
            f"fps_incl={stats['fps_incl_retrieval']:.2f} "
            f"fps_excl={stats['fps_excl_retrieval']:.2f} "
            f"blended_gflops/frame={stats['blended_flops_per_frame'] / 1e9:.3f}"
        )
        if "avg_iou" in stats:
            line += (
                f" avg_iou={stats['avg_iou']:.3f} "
                f"precision@0.5={stats['precision']:.3f} "
                f"gt_vel={stats['gt_velocity_px_s']:.1f}px/s"
            )
        print(line)

    def mean(key, rows):
        return float(np.mean([r[key] for r in rows])) if rows else 0.0

    rows = list(results.values())
    agg = {k: mean(k, rows)
           for k in ("fps_incl_retrieval", "fps_excl_retrieval", "blended_flops_per_frame")}
    scored = [r for r in rows if "avg_iou" in r]
    if scored:
        agg["avg_iou"] = mean("avg_iou", scored)
        agg["precision"] = mean("precision", scored)
        agg["num_detections"] = int(np.sum([r["num_detections"] for r in scored]))
    return {"per_sequence": results, "aggregate": agg}


def _gt_frame_xyxy(per_frame: dict[int, np.ndarray], i: int) -> np.ndarray:
    """One frame's (N, 5) [class, cx, cy, w, h] pixel labels -> (N, 4)
    xyxy; (0, 4) when the frame has none."""
    raw = per_frame.get(i)
    if raw is None or raw.shape[0] == 0:
        return np.zeros((0, 4), np.float32)
    cx, cy, w, h = raw[:, 1], raw[:, 2], raw[:, 3], raw[:, 4]
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=1).astype(np.float32)


def compute_iou_list(detections: np.ndarray, gts: np.ndarray, top_n: int | None = None) -> float:
    """Mean of the top-N best-IoU matches between one frame's detections
    and its ground truth (0 when either is empty)."""
    if detections.size == 0 or gts.size == 0:
        return 0.0
    m = _iou_matrix(detections[:, :4], gts[:, :4])
    best = np.sort(m.max(axis=1))[::-1]
    if top_n is not None:
        best = best[:top_n]
    return float(best.mean()) if best.size else 0.0


def gt_velocity(frame_boxes: list[np.ndarray], frame_dt_s: float = 0.05) -> list[float]:
    """Mean ground-truth box-center speed (px/s) between consecutive
    frames, each center matched to the nearest of the next frame; a frame
    pair with no boxes on either side gives 0."""
    out = []
    for prev, cur in zip(frame_boxes[:-1], frame_boxes[1:]):
        if prev.size == 0 or cur.size == 0:
            out.append(0.0)
            continue
        pc = np.stack([(prev[:, 0] + prev[:, 2]) / 2, (prev[:, 1] + prev[:, 3]) / 2], 1)
        cc = np.stack([(cur[:, 0] + cur[:, 2]) / 2, (cur[:, 1] + cur[:, 3]) / 2], 1)
        d = np.linalg.norm(pc[:, None] - cc[None], axis=-1)
        out.append(float(d.min(axis=1).mean() / frame_dt_s))
    return out
