"""Synthetic DSEC-shaped dataset, written without OpenCV.

The port's copy of the JAX package's ``data/synthetic.py::make_sequence``
and ``make_dataset``: the same on-disk layout,

    <root>/<sequence>/images/left/distorted/*.png      (frames)
    <root>/<sequence>/images/timestamps.txt            (us, int64, col 0)
    <root>/<sequence>/object_detections/left/tracks.npy (Prophesee structured)

with constant-velocity filled rectangles as objects, drawn with numpy
slices (``cv2.rectangle(..., -1)`` on integer corners fills
``[y1..y2] x [x1..x2]`` inclusive) and written with :func:`.png.write_rgb`.
The ``RandomState`` draws come in the same order, so a tree written here
decodes to the JAX generator's pixels and labels, with a byte-equal
``timestamps.txt`` and an equal ``tracks.npy``.

The JAX package's "hard" profile (``make_sequence_hard``: cubic resize,
ellipses, filled and outlined polygons) depends on OpenCV's raster rules
and is not ported.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .png import write_rgb

# Prophesee GEN1-style structured dtype of tracks.npy.
TRACKS_DTYPE = np.dtype(
    [
        ("t", "<u8"),
        ("x", "<f4"),
        ("y", "<f4"),
        ("w", "<f4"),
        ("h", "<f4"),
        ("class_id", "u1"),
        ("class_confidence", "<f4"),
        ("track_id", "<u4"),
    ]
)
COLORS = [(200, 60, 60), (60, 200, 60), (60, 60, 200)]  # RGB, by class mod 3


def make_sequence(
    seq_dir: Path,
    num_frames: int = 12,
    height: int = 96,
    width: int = 128,
    num_objects: int = 2,
    num_classes: int = 3,
    seed: int = 0,
    frame_dt_us: int = 50_000,
    obj_size: tuple[int, int] | None = None,
) -> None:
    """One sequence of moving rectangles. ``obj_size``: (min, max) object
    side in pixels, by default ~10-22% of the short image side: much
    smaller objects starve the TAL assigner's bootstrap (its metric
    score^0.5 * CIoU^6 underflows against the head's initial boxes)."""
    rng = np.random.RandomState(seed)
    seq_dir = Path(seq_dir)
    img_dir = seq_dir / "images/left/distorted"
    img_dir.mkdir(parents=True, exist_ok=True)
    det_dir = seq_dir / "object_detections/left"
    det_dir.mkdir(parents=True, exist_ok=True)

    t0 = 1_000_000
    timestamps = t0 + np.arange(num_frames, dtype=np.int64) * frame_dt_us

    if obj_size is None:
        short = min(height, width)
        obj_size = (max(8, int(0.10 * short)), max(12, int(0.22 * short)))

    margin = obj_size[1] + 12
    obj_xy = rng.uniform(
        [8, 8], [max(9, width - margin), max(9, height - margin)], size=(num_objects, 2)
    )
    obj_v = rng.uniform(-3, 3, size=(num_objects, 2))
    obj_wh = rng.uniform(obj_size[0], obj_size[1], size=(num_objects, 2))
    obj_cls = rng.randint(0, num_classes, size=num_objects)

    records = []
    for f in range(num_frames):
        img = np.full((height, width, 3), 30, np.uint8)
        img += rng.randint(0, 20, size=img.shape, dtype=np.uint8)
        for o in range(num_objects):
            x, y = obj_xy[o] + obj_v[o] * f
            w, h = obj_wh[o]
            x1, y1 = int(max(0, x)), int(max(0, y))
            x2 = int(min(width - 1, x + w))
            y2 = int(min(height - 1, y + h))
            if x2 <= x1 or y2 <= y1:
                continue
            img[y1 : y2 + 1, x1 : x2 + 1] = COLORS[obj_cls[o] % 3]
            # Detection timestamp jittered around the frame time (exercises
            # the nearest-timestamp alignment).
            det_t = int(timestamps[f] + rng.randint(-5000, 5000))
            records.append((max(det_t, 0), x, y, w, h, obj_cls[o], 1.0, o))
        write_rgb(img_dir / f"{f:06d}.png", img)

    np.savetxt(
        seq_dir / "images/timestamps.txt",
        np.stack([timestamps, timestamps], axis=1),
        fmt="%d",
    )
    tracks = np.sort(np.array(records, dtype=TRACKS_DTYPE), order="t")
    np.save(det_dir / "tracks.npy", tracks)


def make_dataset(
    root: Path | str,
    num_sequences: int = 3,
    splits: tuple[str, ...] = ("train", "test"),
    **kwargs,
) -> Path:
    """Build <root>/{split}/{seq_xx}/... Returns the root path."""
    root = Path(root)
    for split in splits:
        for i in range(num_sequences):
            make_sequence(root / split / f"seq_{i:02d}", seed=i + 100 * len(split), **kwargs)
    return root
