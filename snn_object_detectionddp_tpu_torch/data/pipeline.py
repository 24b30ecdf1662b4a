"""Fixed-shape host input pipeline: decode -> pad -> batch -> prefetch.

The port's copy of the JAX package's ``data/pipeline.py`` with the same
batch contract:

- images:  (B, T, H, W, 3) uint8, all B*T frames decoded in one
  :func:`.native.decode_batch` call on the port's one PNG decoder
  (``csrc/png_decode.cpp``, its own thread pool, without the interpreter
  lock). The JAX package's opt-in ``SNN_TPU_NATIVE_DECODE`` has no
  counterpart: the port has no other decode path. Normalization and spike
  encoding happen on the device (:mod:`.encoding`);
- labels:  (B, M, 5) float32 [class, cx, cy, w, h] normalized, zero-padded;
- label_mask: (B, M) bool;
- sample_mask: (B,) bool — False on the padding rows of a final partial
  batch, which repeats the last real sample's frames to keep the shape;
- paths: the last-frame path of each real sample.

A background thread assembles batches ahead of consumption (depth
``prefetch``) so host decode overlaps device compute. A failed decode
or build raises to the consumer; nothing falls back.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from . import native
from .dsec import DSECIndex
from .png import png_shape


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

    def _decode(self, samples) -> np.ndarray:
        """The frames of ``samples``: (b, T, H, W, 3) uint8, all b*T decoded
        in one :func:`.native.decode_batch` call at the first frame's size,
        then ``transform``."""
        paths = [p for s in samples for p in s.frame_paths]
        h, w = png_shape(paths[0])
        images = native.decode_batch(paths, h, w, self.num_threads).reshape(len(samples), -1, h, w, 3)
        if self.transform is not None:
            images = np.stack([np.stack([self.transform(f) for f in seq]) for seq in images])
        return images

    def _make_batch(self, batch_indices: list[int]) -> dict:
        samples = [self.index.samples[i] for i in batch_indices]
        images = self._decode(samples)
        b, bs = len(samples), self.batch_size
        img_h, img_w = images.shape[2:4]
        sample_mask = np.zeros((bs,), bool)
        sample_mask[:b] = True
        if b < bs:  # pad a final partial batch to the fixed shape
            images = np.concatenate([images, np.repeat(images[-1:], bs - b, axis=0)], axis=0)
        batch = {"images": images, "sample_mask": sample_mask,
                 "paths": [s.last_frame_path for s in samples]}
        if self.index.mode in ("train", "val"):
            labels = np.zeros((bs, self.max_boxes, 5), np.float32)
            masks = np.zeros((bs, self.max_boxes), bool)
            for k, idx in enumerate(batch_indices):
                labels[k], masks[k] = pad_labels(self.index.sample_labels(idx, img_h, img_w),
                                                 self.max_boxes)
            batch["labels"] = labels
            batch["label_mask"] = masks
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
            try:
                for chunk in chunks:
                    if stop.is_set() or not _put(self._make_batch(chunk)):
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
