"""Synthetic DSEC-shaped dataset, written without OpenCV.

The port's copy of the JAX package's ``data/synthetic.py``
(``make_sequence``, ``make_dataset`` and the "hard" profile
``make_sequence_hard``): the same on-disk layout,

    <root>/<sequence>/images/left/distorted/*.png      (frames)
    <root>/<sequence>/images/timestamps.txt            (us, int64, col 0)
    <root>/<sequence>/object_detections/left/tracks.npy (Prophesee structured)

written with :func:`.png.write_rgb`. ``make_sequence`` draws its
constant-velocity filled rectangles with numpy slices
(``cv2.rectangle(..., -1)`` on integer corners fills ``[y1..y2] x
[x1..x2]`` inclusive); ``make_sequence_hard`` draws its textured
background, shape-coded objects, outlined distractors and occluder bars
with :mod:`.raster`, which reproduces the cv2 primitives the JAX generator
calls. The ``RandomState`` draws come in the same order and the
photometric expressions are the same, so a tree written here decodes to
the JAX generator's pixels and labels, with a byte-equal
``timestamps.txt`` and an equal ``tracks.npy``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import raster
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


def _textured_background(rng: np.random.RandomState, height: int, width: int) -> np.ndarray:
    """Low-frequency smoothed noise + static 'building' clutter."""
    low = rng.randint(20, 120, size=(height // 16 + 1, width // 16 + 1, 3))
    bg = raster.resize_cubic(low.astype(np.uint8), (height, width))
    # Static outline clutter (buildings/windows): rectangles in bg tones.
    for _ in range(10):
        x1 = rng.randint(0, width - 8)
        y1 = rng.randint(0, height - 8)
        x2 = min(width - 1, x1 + rng.randint(8, max(9, width // 4)))
        y2 = min(height - 1, y1 + rng.randint(8, max(9, height // 4)))
        tone = tuple(int(c) for c in rng.randint(25, 110, 3))
        raster.rectangle(bg, (x1, y1), (x2, y2), tone, rng.choice([1, 2, -1]))
    return bg


def _draw_shape(img: np.ndarray, cls: int, x1: int, y1: int, x2: int, y2: int, color: tuple) -> None:
    """Class is encoded by SHAPE only (colours are random per object):
    0 = rectangle, 1 = ellipse, 2 = triangle, all filled (the distractors
    are the outlined family)."""
    if cls % 3 == 0:
        raster.rectangle(img, (x1, y1), (x2, y2), color, -1)
    elif cls % 3 == 1:
        cx, cy = (x1 + x2) // 2, (y1 + y2) // 2
        ax, ay = max(1, (x2 - x1) // 2), max(1, (y2 - y1) // 2)
        raster.ellipse(img, (cx, cy), (ax, ay), color, -1)
    else:
        raster.fill_poly(img, [[(x1 + x2) // 2, y1], [x1, y2], [x2, y2]], color)


def make_sequence_hard(
    seq_dir: Path,
    num_frames: int = 12,
    height: int = 96,
    width: int = 128,
    num_objects: int = 4,
    num_classes: int = 3,
    seed: int = 0,
    frame_dt_us: int = 50_000,
    num_distractors: int = 5,
    num_occluders: int = 2,
    min_scale: float = 0.04,
    max_scale: float = 0.20,
    noise: float = 6.0,
    jitter: tuple[float, float] = (0.75, 1.25),
) -> None:
    """One "hard" sequence: a textured, cluttered background; classes told
    apart by shape only (random colours); objects of 4-20% of the short
    side by default, drifting in scale; unlabeled outlined distractors of
    the same shape families; static occluder bars drawn over everything
    (labels keep the full object extent); per-frame gain/offset jitter and
    pixel noise."""
    rng = np.random.RandomState(seed)
    seq_dir = Path(seq_dir)
    img_dir = seq_dir / "images/left/distorted"
    img_dir.mkdir(parents=True, exist_ok=True)
    det_dir = seq_dir / "object_detections/left"
    det_dir.mkdir(parents=True, exist_ok=True)

    t0 = 1_000_000
    timestamps = t0 + np.arange(num_frames, dtype=np.int64) * frame_dt_us
    short = min(height, width)

    bg = _textured_background(rng, height, width)

    # Labeled objects: shape-coded class, random colours, mixed scales.
    obj_cls = rng.randint(0, num_classes, size=num_objects)
    obj_wh = np.stack(
        [
            rng.uniform(min_scale * short, max_scale * short, size=num_objects),
            rng.uniform(min_scale * short, max_scale * short, size=num_objects),
        ],
        axis=1,
    )
    obj_xy = rng.uniform(
        [4, 4],
        [width - obj_wh[:, 0].max() - 8, height - obj_wh[:, 1].max() - 8],
        size=(num_objects, 2),
    )
    obj_v = rng.uniform(-3, 3, size=(num_objects, 2))
    obj_color = [tuple(int(c) for c in rng.randint(70, 230, 3)) for _ in range(num_objects)]
    obj_grow = rng.uniform(-0.01, 0.01, size=num_objects)  # scale drift

    # Unlabeled distractors: outlined versions of the same shape families.
    dis_cls = rng.randint(0, num_classes, size=num_distractors)
    dis_wh = rng.uniform(0.05 * short, 0.18 * short, size=(num_distractors, 2))
    dis_xy = rng.uniform([4, 4], [width - 24, height - 24], size=(num_distractors, 2))
    dis_v = rng.uniform(-2.5, 2.5, size=(num_distractors, 2))
    dis_color = [tuple(int(c) for c in rng.randint(70, 230, 3)) for _ in range(num_distractors)]

    # Static occluder bars (poles/railings), drawn last, over everything.
    occ = []
    for _ in range(num_occluders):
        if rng.rand() < 0.5:
            x = rng.randint(0, max(1, width - 6))
            occ.append(("v", x, rng.randint(3, max(4, width // 24))))
        else:
            y = rng.randint(0, max(1, height - 6))
            occ.append(("h", y, rng.randint(3, max(4, height // 24))))
    occ_color = tuple(int(c) for c in rng.randint(15, 60, 3))

    records = []
    for f in range(num_frames):
        img = bg.copy()
        # Distractors first (objects may overlap them).
        for o in range(num_distractors):
            x, y = dis_xy[o] + dis_v[o] * f
            w, h = dis_wh[o]
            x1, y1 = int(x), int(y)
            x2, y2 = int(x + w), int(y + h)
            if x2 <= 0 or y2 <= 0 or x1 >= width - 1 or y1 >= height - 1:
                continue
            x1, y1 = max(0, x1), max(0, y1)
            x2, y2 = min(width - 1, x2), min(height - 1, y2)
            if x2 <= x1 or y2 <= y1:
                continue
            c = dis_cls[o] % 3
            thick = 2
            if c == 0:
                raster.rectangle(img, (x1, y1), (x2, y2), dis_color[o], thick)
            elif c == 1:
                raster.ellipse(
                    img,
                    ((x1 + x2) // 2, (y1 + y2) // 2),
                    (max(1, (x2 - x1) // 2), max(1, (y2 - y1) // 2)),
                    dis_color[o], thick,
                )
            else:
                raster.polylines(img, [[(x1 + x2) // 2, y1], [x1, y2], [x2, y2]], True, dis_color[o], thick)
        # Labeled objects.
        for o in range(num_objects):
            scale = max(0.3, 1.0 + obj_grow[o] * f)
            x, y = obj_xy[o] + obj_v[o] * f
            w, h = obj_wh[o] * scale
            x1, y1 = int(max(0, x)), int(max(0, y))
            x2 = int(min(width - 1, x + w))
            y2 = int(min(height - 1, y + h))
            if x2 - x1 < 3 or y2 - y1 < 3:
                continue
            _draw_shape(img, obj_cls[o], x1, y1, x2, y2, obj_color[o])
            det_t = int(timestamps[f] + rng.randint(-5000, 5000))
            records.append((max(det_t, 0), x1, y1, x2 - x1, y2 - y1, obj_cls[o], 1.0, o))
        # Occluders over everything (partial occlusion of objects).
        for kind, pos, thick in occ:
            if kind == "v":
                raster.rectangle(img, (pos, 0), (pos + thick, height - 1), occ_color, -1)
            else:
                raster.rectangle(img, (0, pos), (width - 1, pos + thick), occ_color, -1)
        # Photometric jitter + pixel noise (the JAX generator's expressions:
        # float32 image, float64 noise added in place).
        gain = rng.uniform(*jitter)
        offset = rng.uniform(-18, 18)
        img = np.clip(img.astype(np.float32) * gain + offset, 0, 255)
        img += rng.randn(*img.shape) * noise
        img = np.clip(img, 0, 255).astype(np.uint8)
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
