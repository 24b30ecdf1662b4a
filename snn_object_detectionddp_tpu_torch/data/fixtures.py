"""The "hard" synthetic fixtures, written by the port.

The port's copy of the JAX package's ``scripts/make_hard_fixture.py``:
the same seeds and generator parameters, through
:func:`.synthetic.make_sequence_hard`, each tree idempotent through a
``.fixture_done`` marker.

- :func:`make_hard_nano`: ``fixtures/hard_nano/{train,test}`` at 128x160
  (80 + 6 sequences of 16 frames), the tree that ``fixtures/hard_nano_ckpt.pt``
  was trained and is evaluated on (``scripts/hard_nano.yaml``).
- :func:`make_hard_flagship`: ``runs/hard/dsec/{train,test}`` at 480x640
  (40 + 8 sequences of 24 frames).
- :func:`tree_digest`: a sha256 over a tree's decoded content, which the
  port's trees and the JAX generator's trees share.

    python -m snn_object_detectionddp_tpu_torch.data.fixtures nano|flagship|both

The pinned constants below are what ``scripts/torch_fixture_pins.py``
printed on a CPU with JAX (x86-64, OpenCV 5.0.0 with Intel IPP, JAX 0.9.0):
the digests of the trees the port writes, equal to those of the JAX
generator's trees, and the JAX package's metrics of the fixture checkpoint
on that nano tree in fp32 and bf16 (``evaluate_model``, the yaml's seeded
validation split, batch 16).
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import numpy as np

from .png import read_rgb
from .synthetic import make_sequence_hard

REPO = Path(__file__).resolve().parents[2]

NANO = dict(num_frames=16, height=128, width=160, num_objects=4, num_classes=3, min_scale=0.10,
            max_scale=0.28, noise=3.0, jitter=(0.90, 1.10), num_distractors=4)
NANO_SEEDS = {"train": [5000 + i for i in range(80)], "test": [8000 + i for i in range(6)]}
FLAGSHIP = dict(num_frames=24, height=480, width=640, num_objects=4, num_classes=3, min_scale=0.05,
                max_scale=0.22, noise=4.0, jitter=(0.85, 1.15))
FLAGSHIP_SEEDS = {"train": [3000 + i for i in range(40)], "test": [7000 + i for i in range(8)]}

# scripts/torch_fixture_pins.py with JAX on the CPU (see the module docstring).
NANO_DIGEST = "7839c7feb824831ec73112bbc40290ce9dbaac0aebb83c4d308d125ad55527b1"
FLAGSHIP_SEQ00_DIGEST = "5480282aae46aead2a2917e85b34d557776f90264ddaf04afb0103442cba120f"
METRIC_KEYS = ("metrics/mAP50(B)", "metrics/mAP50-95(B)", "metrics/precision(B)",
               "metrics/recall(B)", "fitness")
JAX_F32_METRICS = {
    "metrics/mAP50(B)": 0.40303435169157603,
    "metrics/mAP50-95(B)": 0.1851618750296629,
    "metrics/precision(B)": 0.48282751018875913,
    "metrics/recall(B)": 0.4756438587487855,
    "fitness": 0.2069491226958542,
}
JAX_BF16_METRICS = {
    "metrics/mAP50(B)": 0.4129515190100796,
    "metrics/mAP50-95(B)": 0.19913964014242516,
    "metrics/precision(B)": 0.4914705864857107,
    "metrics/recall(B)": 0.4843879411770326,
    "fitness": 0.22052082802919062,
}


def write_tree(root: Path, params: dict, seeds: dict[str, list[int]]) -> Path:
    """Write ``root/{split}/seq_XX`` for each split's seeds, then the
    ``.fixture_done`` marker; a tree that has the marker is left as it is."""
    root = Path(root)
    if (root / ".fixture_done").exists():
        return root
    for split, split_seeds in seeds.items():
        for i, seed in enumerate(split_seeds):
            make_sequence_hard(root / split / f"seq_{i:02d}", seed=seed, **params)
    (root / ".fixture_done").touch()
    return root


def make_hard_nano(root: Path | str | None = None) -> Path:
    """The nano tree (default ``fixtures/hard_nano`` in the repository)."""
    return write_tree(Path(root) if root is not None else REPO / "fixtures/hard_nano", NANO, NANO_SEEDS)


def make_hard_flagship(root: Path | str | None = None) -> Path:
    """The flagship tree (default ``runs/hard/dsec`` in the repository)."""
    return write_tree(Path(root) if root is not None else REPO / "runs/hard/dsec", FLAGSHIP,
                      FLAGSHIP_SEEDS)


def tree_digest(root: Path | str) -> str:
    """sha256 over every frame, ``timestamps.txt`` and ``tracks.npy`` under
    ``root``, in the order of their sorted relative paths: each path, then a
    frame's decoded RGB pixels and shape, the timestamps' bytes, or the
    tracks' dtype and records. Other files (the marker) do not count, so
    two trees with equal content and different PNG encodings agree."""
    root = Path(root)
    h = hashlib.sha256()
    for path in sorted(root.rglob("*"), key=lambda p: p.relative_to(root).as_posix()):
        rel = path.relative_to(root).as_posix()
        if path.suffix == ".png":
            px = read_rgb(path)
            body = repr(px.shape).encode() + px.tobytes()
        elif path.name == "timestamps.txt":
            body = path.read_bytes()
        elif path.name == "tracks.npy":
            tracks = np.load(path)
            body = str(tracks.dtype.descr).encode() + tracks.tobytes()
        else:
            continue
        h.update(rel.encode() + b"\0" + hashlib.sha256(body).digest())
    return h.hexdigest()


def main(argv: list[str]) -> None:
    which = argv[0] if argv else "both"
    if which not in ("nano", "flagship", "both"):
        raise SystemExit("usage: python -m snn_object_detectionddp_tpu_torch.data.fixtures nano|flagship|both")
    if which in ("both", "nano"):
        print(f"nano fixture at {make_hard_nano()}")
    if which in ("both", "flagship"):
        print(f"flagship fixture at {make_hard_flagship()}")


if __name__ == "__main__":
    main(sys.argv[1:])
