"""Tracker benchmark from the command line.

    python -m snn_object_detectionddp_tpu_torch.eval --config config.yaml \
        [--method entire_model|cropped_model|optical_flow] [--stride 5] \
        [--adaptive-stride] [--max-frames N] [--annotate] [--weights best.pt]

The port's counterpart of the JAX package's root ``eval.py``: the detector
every frame, in a crop window, or every ``stride`` frames with optical
flow in between (evals/legacy.py), over the test split the config names;
per-sequence FPS (incl/excl frame retrieval), blended FLOPs per frame and,
where the split has ``tracks.npy``, average IoU and precision at 0.5,
then the aggregate as JSON. Weights: ``--weights`` or
``<save_dir>/best.pt``, a checkpoint of this package or a flax file
(``convert.load_weights``); without one it warns and benchmarks the
seeded initialisation. Runs on the card; the config is read without
PyYAML.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from .convert import load_weights
from .evals.legacy import default_adaptive_stride, process_dataset
from .models.detector import Detector, set_tf32_policy
from .parallel.mesh import process_device


def benchmark(cfg, args, device: str | torch.device = "cuda") -> dict:
    """Run the tracker benchmark that ``args`` (the parsed flags) ask for;
    returns process_dataset's report."""
    detector = Detector.from_config(cfg, device=device)
    weights = Path(args.weights or Path(cfg.training.save_dir) / "best.pt")
    if weights.exists():
        params = load_weights(detector, weights)
    else:
        print(f"WARNING: no checkpoint at {weights}; benchmarking fresh init.")
        params = detector.init_params(torch.Generator().manual_seed(0))
    return process_dataset(
        cfg, detector, params, method=args.method, stride=args.stride,
        max_frames_per_seq=args.max_frames, annotate=args.annotate,
        compute_stride=default_adaptive_stride if args.adaptive_stride else None,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="config.yaml")
    ap.add_argument("--method", default="optical_flow",
                    choices=["entire_model", "cropped_model", "optical_flow"])
    ap.add_argument("--stride", type=int, default=5)
    ap.add_argument("--adaptive-stride", action="store_true",
                    help="optical_flow method only: adapt the detector interval to tracking IoU")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--annotate", action="store_true")
    ap.add_argument("--weights", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("eval needs a CUDA card (torch.cuda.is_available() is False)")
    from .config import load_config

    cfg = load_config(args.config)
    set_tf32_policy(cfg.runtime.precision)
    report = benchmark(cfg, args, device=process_device())
    print(json.dumps(report["aggregate"], indent=2))
    return report


if __name__ == "__main__":
    main()
