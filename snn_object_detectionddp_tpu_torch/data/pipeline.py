"""Fixed-shape host input pipeline: decode -> pad -> batch -> prefetch.

The port's copy of the JAX package's ``data/pipeline.py`` with the same
batch contract:

- images:  (B, T, H, W, 3) uint8, decoded by a thread pool through
  :func:`.png.read_rgb` (zlib and the compiled row filters release the
  interpreter lock). Normalization and spike encoding happen on the device
  (:mod:`.encoding`);
- labels:  (B, M, 5) float32 [class, cx, cy, w, h] normalized, zero-padded;
- label_mask: (B, M) bool;
- sample_mask: (B,) bool — False on the padding rows of a final partial
  batch, which repeats the last real sample's frames to keep the shape;
- paths: the last-frame path of each real sample.

A background thread assembles batches ahead of consumption (depth
``prefetch``) so host decode overlaps device compute. There is one
decoder: the JAX package's optional C++ whole-batch path is not ported.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from .dsec import DSECIndex
from .png import read_rgb


def pad_labels(labels: np.ndarray, max_boxes: int) -> tuple[np.ndarray, np.ndarray]:
    """(N, 5) -> ((M, 5) zero-padded, (M,) bool mask). Overflow truncates."""
    out = np.zeros((max_boxes, 5), np.float32)
    mask = np.zeros((max_boxes,), bool)
    n = min(labels.shape[0], max_boxes)
    if n:
        out[:n] = labels[:n]
        mask[:n] = True
    return out, mask


class BatchLoader:
    """Iterates fixed-shape batches over a list of sample indices.

    Yields dicts: images (B,T,H,W,3) uint8, sample_mask (B,) bool, paths,
    and (train/val modes) labels (B,M,5) f32 and label_mask (B,M) bool.
    Each iteration is one epoch; with ``shuffle`` epoch ``e`` visits the
    indices in the order of ``RandomState(seed + e)``.
    """

    def __init__(
        self,
        index: DSECIndex,
        indices: list[int],
        batch_size: int,
        max_boxes: int = 64,
        shuffle: bool = False,
        seed: int = 42,
        num_threads: int = 4,
        prefetch: int = 2,
        drop_last: bool = False,
        transform=None,
    ):
        # ``transform``: optional per-frame callable (H,W,3) uint8 ->
        # (H,W,3) uint8 applied at decode time on the host. It must keep
        # the geometry: labels are not re-derived.
        self.transform = transform
        self.index = index
        self.indices = list(indices)
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.indices)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _load_sample(self, idx: int):
        s = self.index.samples[idx]
        frames = [read_rgb(p) for p in s.frame_paths]
        if self.transform is not None:
            frames = [self.transform(f) for f in frames]
        img_h, img_w = frames[-1].shape[:2]
        images = np.stack(frames)  # (T, H, W, 3) uint8
        if self.index.mode in ("train", "val"):
            lab, mask = pad_labels(self.index.sample_labels(idx, img_h, img_w), self.max_boxes)
            return images, lab, mask, s.last_frame_path
        return images, None, None, s.last_frame_path

    def _make_batch(self, batch_indices: list[int], pool: ThreadPoolExecutor) -> dict:
        results = list(pool.map(self._load_sample, batch_indices))
        b, bs = len(results), self.batch_size
        images = np.stack([r[0] for r in results])
        sample_mask = np.zeros((bs,), bool)
        sample_mask[:b] = True
        if b < bs:  # pad a final partial batch to the fixed shape
            images = np.concatenate([images, np.repeat(images[-1:], bs - b, axis=0)], axis=0)
        batch = {"images": images, "sample_mask": sample_mask, "paths": [r[3] for r in results]}
        if self.index.mode in ("train", "val"):
            labels = np.stack([r[1] for r in results])
            masks = np.stack([r[2] for r in results])
            if b < bs:
                labels = np.concatenate([labels, np.zeros((bs - b,) + labels.shape[1:], np.float32)])
                masks = np.concatenate([masks, np.zeros((bs - b,) + masks.shape[1:], bool)])
            batch["labels"] = labels
            batch["label_mask"] = masks & sample_mask[:, None]
        return batch

    def __iter__(self) -> Iterator[dict]:
        order = np.array(self.indices)
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        chunks = [
            [int(i) for i in order[k * self.batch_size : (k + 1) * self.batch_size]]
            for k in range(len(self))
        ]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def _put(item) -> bool:
            # Bounded put that gives up once the consumer has walked away
            # (``stop`` is set when the generator closes), so the producer
            # thread and its decoded batches never outlive an abandoned
            # iterator.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
                try:
                    for chunk in chunks:
                        if stop.is_set() or not _put(self._make_batch(chunk, pool)):
                            break
                except Exception as e:  # surfaced to the consumer
                    _put(e)
                finally:
                    _put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join()
