"""DSEC dataset indexing and label alignment (host numpy, no tensors).

The port's copy of the JAX package's ``data/dsec.py``, with the same data
contracts:

- scans ``<root>/<seq>/images/left/distorted/*.png`` per sequence directory
  and ``images/timestamps.txt`` (microseconds, int64, first column);
- loads the Prophesee structured ``object_detections/left/tracks.npy`` and
  assigns each detection to its nearest-timestamp frame (searchsorted with
  a before/after comparison); a detection timestamped before the first
  frame is dropped;
- converts top-left (x, y, w, h) to center form in pixels;
- builds one sliding-window sample per run of ``seq_len`` consecutive
  frames;
- labels a window by its last frame only: filter zero-area boxes,
  normalize by the image size, clip to [0, 1] through an xyxy round trip,
  filter again;
- splits the sequences 80/20 with seed 42. The split draws the same
  permutation as scikit-learn's ``train_test_split`` (which the JAX package
  calls) without needing scikit-learn;
- debug truncation: the first 100 train / 20 val / 600 test samples.

Decoding and batching live in :mod:`.pipeline`, so the index stays cheap.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass(frozen=True)
class Sample:
    image_dir: str
    filenames: tuple[str, ...]  # all frame filenames of the sequence
    start: int  # window start index
    seq_len: int

    @property
    def frame_paths(self) -> list[str]:
        return [
            str(Path(self.image_dir) / self.filenames[self.start + i])
            for i in range(self.seq_len)
        ]

    @property
    def last_frame_path(self) -> str:
        return str(Path(self.image_dir) / self.filenames[self.start + self.seq_len - 1])

    @property
    def last_frame_index(self) -> int:
        return self.start + self.seq_len - 1


def process_tracks(tracks: np.ndarray, frame_timestamps: np.ndarray) -> dict[int, np.ndarray]:
    """Nearest-frame label alignment.

    Returns {frame_idx: (N, 5) float32 [class_id, cx, cy, w, h] in pixels}.
    """
    detection_ts = tracks["t"].astype(np.int64)
    indices = np.searchsorted(frame_timestamps, detection_ts, side="left")
    indices = np.clip(indices, 0, len(frame_timestamps) - 1)
    ts_before = frame_timestamps[np.maximum(0, indices - 1)]
    ts_after = frame_timestamps[indices]
    final = indices - (detection_ts - ts_before < ts_after - detection_ts)

    boxes = np.stack(
        [
            tracks["class_id"].astype(np.float32),
            tracks["x"].astype(np.float32) + tracks["w"].astype(np.float32) / 2.0,
            tracks["y"].astype(np.float32) + tracks["h"].astype(np.float32) / 2.0,
            tracks["w"].astype(np.float32),
            tracks["h"].astype(np.float32),
        ],
        axis=1,
    )
    labels: dict[int, list] = {}
    for i, fidx in enumerate(final):
        # A detection before the first frame gets index -1: it belongs to
        # no frame of the sequence and is dropped, not wrapped to the last.
        if fidx < 0:
            continue
        labels.setdefault(int(fidx), []).append(boxes[i])
    return {k: np.stack(v).astype(np.float32) for k, v in labels.items()}


def normalize_and_clip(labels_px: np.ndarray, img_h: int, img_w: int) -> np.ndarray:
    """(N, 5) [class, cx, cy, w, h] pixels -> normalized, clipped, filtered:
    zero-area filter, normalize by the image size, clip through an xyxy
    round trip, filter again."""
    arr = labels_px.astype(np.float32).copy()
    arr = arr[(arr[:, 3] > 0) & (arr[:, 4] > 0)]
    if arr.shape[0] == 0:
        return np.zeros((0, 5), np.float32)
    arr[:, 1] /= img_w
    arr[:, 2] /= img_h
    arr[:, 3] /= img_w
    arr[:, 4] /= img_h
    cx, cy, w, h = arr[:, 1], arr[:, 2], arr[:, 3], arr[:, 4]
    x1 = np.clip(cx - w / 2, 0, 1)
    y1 = np.clip(cy - h / 2, 0, 1)
    x2 = np.clip(cx + w / 2, 0, 1)
    y2 = np.clip(cy + h / 2, 0, 1)
    arr[:, 1] = (x1 + x2) / 2
    arr[:, 2] = (y1 + y2) / 2
    arr[:, 3] = x2 - x1
    arr[:, 4] = y2 - y1
    arr = arr[(arr[:, 3] > 0) & (arr[:, 4] > 0)]
    return arr if arr.shape[0] else np.zeros((0, 5), np.float32)


class DSECIndex:
    """Sliding-window index over a DSEC split directory."""

    def __init__(self, config, mode: str = "train"):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"Invalid mode '{mode}'. Choose from 'train', 'val', or 'test'.")
        self.mode = mode
        split_cfg = config.dataset.split(mode)
        self.seq_len = split_cfg.seq_len
        root = Path(split_cfg.path)

        self.samples: list[Sample] = []
        self.labels: dict[str, dict[int, np.ndarray]] = {}

        for seq_path in sorted(d for d in root.iterdir() if d.is_dir()):
            image_dir = seq_path / "images/left/distorted"
            image_files = sorted(image_dir.glob("*.png"))
            num_images = len(image_files)
            frame_ts = np.loadtxt(seq_path / "images/timestamps.txt", usecols=0, dtype=np.int64)
            tracks_path = seq_path / "object_detections/left/tracks.npy"
            # Train/val need labels; a test split is labelled where it has
            # a tracks.npy (its quality metrics score against it).
            if self.mode in ("train", "val") or tracks_path.exists():
                self.labels[str(image_dir)] = process_tracks(np.load(tracks_path), frame_ts)
            if num_images >= self.seq_len:
                names = tuple(f.name for f in image_files)
                for i in range(num_images - self.seq_len + 1):
                    self.samples.append(Sample(str(image_dir), names, i, self.seq_len))
        print(f"Dataset initialized with {len(self.samples)} total sequences.")

    def __len__(self) -> int:
        return len(self.samples)

    def sample_labels(self, idx: int, img_h: int, img_w: int) -> np.ndarray:
        """Normalized (N, 5) labels of the window's last frame."""
        s = self.samples[idx]
        raw = self.labels.get(s.image_dir, {}).get(s.last_frame_index)
        if raw is None or raw.shape[0] == 0:
            return np.zeros((0, 5), np.float32)
        return normalize_and_clip(raw, img_h, img_w)


def split_sequences(n: int, test_size: float = 0.2, seed: int = 42) -> tuple[np.ndarray, np.ndarray]:
    """Positions of the (train, test) sequences among ``n``: the draw of
    scikit-learn's ``train_test_split(range(n), test_size=test_size,
    random_state=seed)``. One permutation from ``RandomState(seed)``; the
    first ceil(test_size * n) are the test set, the next
    floor((1 - test_size) * n) the train set. Raises ``ValueError`` where
    scikit-learn does: when either set would be empty."""
    n_test = math.ceil(test_size * n)
    n_train = math.floor((1.0 - test_size) * n)
    if n_test == 0 or n_train == 0:
        raise ValueError(
            f"With n_samples={n}, test_size={test_size} and train_size=None, the "
            "resulting train or test set will be empty."
        )
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test : n_test + n_train], perm[:n_test]


def train_val_split(index: DSECIndex, test_size: float = 0.2,
                    seed: int = 42) -> tuple[list[int], list[int]]:
    """Sequence-level 80/20 split: group sample indices by sequence
    directory, split the sequences (:func:`split_sequences`), then expand
    back to sample indices in scan order."""
    seq_groups: dict[str, list[int]] = {}
    for idx, s in enumerate(index.samples):
        seq_groups.setdefault(s.image_dir, []).append(idx)
    seqs = list(seq_groups)
    train_pos, _ = split_sequences(len(seqs), test_size, seed)
    train_set = {seqs[i] for i in train_pos}
    train_idx: list[int] = []
    val_idx: list[int] = []
    for seq, indices in seq_groups.items():
        (train_idx if seq in train_set else val_idx).extend(indices)
    return train_idx, val_idx


def apply_train_debug(train_idx: list[int], val_idx: list[int],
                      enabled: bool) -> tuple[list[int], list[int]]:
    """First 100 train / 20 val samples."""
    if not enabled:
        return train_idx, val_idx
    print("DEBUG MODE: Using a smaller subset for quick iterations.")
    return train_idx[:100], val_idx[:20]


def apply_test_debug(indices: list[int], enabled: bool) -> list[int]:
    """First <=600 test samples."""
    if not enabled:
        return indices
    print("DEBUG MODE: Using a smaller subset for quick iterations.")
    return indices[: min(600, len(indices))]
