"""Detection overlays on the test split (``mode: visualize``).

The port's counterpart of the JAX package's ``viz/overlay.py``: per batch
of test windows, the recurrent forward and NMS (conf 0.3, iou 0.45,
multi-label) on the detector's device, boxes scaled from the model's size
to each PNG's own, drawn in the class's palette colour and written as a
PNG named after the window's last frame.

Boxes are drawn by ``data/raster.py::rectangle`` (OpenCV's rectangle,
byte for byte) and frames read and written by ``data/png.py``. The label
text is ``cv2.putText`` (a Hershey font with anti-aliasing): the
repository holds no font data, so :func:`_put_label` imports OpenCV and
raises, naming the call, where it is not installed. ``run_visualization``
asks for it before it reads anything, as the JAX module fails at import.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..data.dsec import DSECIndex, apply_test_debug
from ..data.pipeline import BatchLoader
from ..data.png import read_rgb, write_rgb
from ..data.raster import rectangle
from ..ops.boxes import scale_boxes
from ..train.loop import _progress
from .palette import class_color

VIZ_CONF = 0.3
VIZ_IOU = 0.45


def _put_label():
    """``cv2.putText`` at the overlay's font (Hershey simplex, scale 0.5,
    thickness 1, anti-aliased), as ``put(img, text, org, color)``. Raises
    ImportError naming the call when OpenCV is not installed."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "overlay labels are drawn by cv2.putText (OpenCV's Hershey font; the repository "
            "holds no font data), and OpenCV is not installed"
        ) from e

    def put(img, text, org, color):
        cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1, cv2.LINE_AA)

    return put


def draw_bboxes(
    image_bgr: np.ndarray,
    boxes_xyxy: np.ndarray,
    scores: np.ndarray | None = None,
    classes: np.ndarray | None = None,
    class_names: list[str] | None = None,
) -> np.ndarray:
    """A copy of ``image_bgr`` with each box drawn at thickness 2 in its
    class's colour, corners rounded half to even; with ``scores``, a
    ``"<class> <score>"`` label above each box (cv2.putText)."""
    out = np.array(image_bgr, dtype=np.uint8, order="C", copy=True)
    put = _put_label() if scores is not None else None
    for i, box in enumerate(boxes_xyxy):
        x1, y1, x2, y2 = (int(round(float(v))) for v in box)
        cls = int(classes[i]) if classes is not None else 0
        color = class_color(cls)
        rectangle(out, (x1, y1), (x2, y2), color, 2)
        if put is not None:
            name = class_names[cls] if class_names and cls < len(class_names) else str(cls)
            put(out, f"{name} {float(scores[i]):.2f}", (x1, max(y1 - 15, 10)), color)
    return out


def run_visualization(
    cfg,
    detector,
    params,
    output_dir: str | Path,
    batch_size: int = 8,
    class_names: list[str] | None = None,
) -> list[str]:
    """Render overlays for the test split into ``output_dir``; returns the
    saved paths. ``params`` must be on the detector's device."""
    from ..evals.validator import make_predict_fn

    _put_label()  # fail before any work where OpenCV is missing
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    index = DSECIndex(cfg, "test")
    indices = apply_test_debug(list(range(len(index))), cfg.debug_test)
    loader = BatchLoader(index, indices, batch_size=batch_size, shuffle=False,
                         num_threads=cfg.training.num_workers)
    predict = make_predict_fn(detector, conf=VIZ_CONF, iou=VIZ_IOU, multi_label=True)

    saved = []
    for batch in _progress(loader, "Visualizing", len(loader)):
        out = {k: v.cpu().numpy() for k, v in predict(params, batch["images"]).items()}
        model_hw = batch["images"].shape[2:4]
        for i, path in enumerate(batch["paths"]):
            orig = read_rgb(path)[..., ::-1]  # BGR, as the JAX package reads it
            valid = out["valid"][i]
            boxes = out["boxes"][i][valid]
            if boxes.size:
                boxes = scale_boxes(torch.from_numpy(boxes), model_hw, orig.shape[:2]).numpy()
            img = draw_bboxes(orig, boxes, out["scores"][i][valid], out["classes"][i][valid],
                              class_names)
            dst = output_dir / Path(path).name
            write_rgb(dst, img[..., ::-1])
            saved.append(str(dst))
    return saved
