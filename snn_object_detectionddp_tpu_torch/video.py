"""Stitch the visualization PNGs into an MP4 from the command line.

    python -m snn_object_detectionddp_tpu_torch.video --config config.yaml \
        [--frames DIR] [--output video/output.mp4] [--fps 30]

The port's counterpart of the JAX package's root ``video.py``: the frames
default to ``<save_dir>/visualizations`` (what ``mode: visualize``
writes). A host tool: it needs no card, and needs OpenCV for the MP4
writer (viz/video.py).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .viz.video import stitch_video


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="config.yaml")
    ap.add_argument("--frames", default=None, help="PNG folder override")
    ap.add_argument("--output", default="video/output.mp4")
    ap.add_argument("--fps", type=int, default=30)
    args = ap.parse_args(argv)
    frames = args.frames
    if frames is None:
        from .config import load_config

        frames = str(Path(load_config(args.config).training.save_dir) / "visualizations")
    return stitch_video(frames, args.output, args.fps)


if __name__ == "__main__":
    main()
