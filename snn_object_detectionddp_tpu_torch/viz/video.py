"""Stitch overlay PNGs into an MP4 (mp4v, 30 fps by default).

The port's counterpart of the JAX package's ``viz/video.py``. Frames are
read by ``data/png.py::read_rgb`` and a frame of another size is resized
by ``data/resize.py`` (OpenCV's INTER_LINEAR, byte for byte); the MP4 is
written by ``cv2.VideoWriter``, which needs OpenCV's video encoder: each
function imports OpenCV and raises, naming the call, where it is not
installed.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..data.png import read_rgb
from ..data.resize import resize_linear_u8

_NO_CV2 = "MP4 files are written by cv2.VideoWriter (mp4v), and OpenCV is not installed"


def stitch_video(
    frames_dir: str | Path,
    output_path: str | Path = "video/output.mp4",
    fps: int = 30,
) -> str:
    """Write the PNGs of ``frames_dir``, in name order, as an MP4 at the
    first frame's size; returns its path."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(_NO_CV2) from e
    frames_dir = Path(frames_dir)
    files = sorted(frames_dir.glob("*.png"))
    if not files:
        raise FileNotFoundError(f"No PNG frames in {frames_dir}")
    h, w = read_rgb(files[0]).shape[:2]
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    writer = cv2.VideoWriter(str(output_path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    try:
        for f in files:
            img = read_rgb(f)
            if img.shape[:2] != (h, w):
                img = resize_linear_u8(img, (h, w))
            writer.write(np.ascontiguousarray(img[..., ::-1]))  # BGR
    finally:
        writer.release()
    print(f"Video saved to {output_path} ({len(files)} frames @ {fps} fps)")
    return str(output_path)


def frames_to_video(
    frames,
    output_path: str | Path,
    fps: int = 30,
    rgb: bool = True,
) -> str:
    """Write an in-memory (N, H, W, 3) frame stack as an MP4; returns its
    path. uint8 frames are written as they are, float frames in [0, 1]
    scaled by 255 (others clipped to [0, 255]); ``rgb=True`` frames are
    turned to the BGR order the writer takes."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(_NO_CV2) from e
    frames = np.asarray(frames)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (N, H, W, 3) frames, got {frames.shape}")
    if frames.dtype != np.uint8:
        scale = 255.0 if float(frames.max(initial=0.0)) <= 1.0 else 1.0
        frames = np.clip(frames * scale, 0, 255).astype(np.uint8)

    n, h, w, _ = frames.shape
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    writer = cv2.VideoWriter(str(output_path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    try:
        for frame in frames:
            writer.write(np.ascontiguousarray(frame[:, :, ::-1]) if rgb else frame)
    finally:
        writer.release()
    print(f"Video saved to {output_path} ({n} frames @ {fps} fps)")
    return str(output_path)
