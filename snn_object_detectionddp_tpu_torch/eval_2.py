"""Model mAP evaluation from the command line.

    python -m snn_object_detectionddp_tpu_torch.eval_2 --config config.yaml [--weights best.pt]

The port's counterpart of the JAX package's ``eval_2.py``: load ``best.pt``
(this package's checkpoint format, ``train/checkpoint.py``) or the given
weights, rebuild the seeded validation split, run the recurrent model, NMS
(conf 0.001, iou 0.6, 300 detections) and print the DetMetrics results.
With no checkpoint it warns and evaluates a fresh initialisation. Runs on
the card; ``--config`` needs PyYAML.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from .evals.validator import evaluate_model
from .models.detector import Detector
from .train.checkpoint import load_checkpoint


def evaluate(cfg, weights: str | None = None, device: str | torch.device = "cuda") -> dict:
    """Evaluate ``weights`` (default ``<save_dir>/best.pt``) on the
    validation split that ``cfg`` names; returns the results dict."""
    if cfg.mesh.spatial > 1 or cfg.mesh.tensor > 1 or cfg.mesh.data > 1:
        raise NotImplementedError(
            "multi-device evaluation (mesh.data/spatial/tensor > 1) waits on the "
            "parallelism slice (ROADMAP §1 item 2); set the mesh to one device"
        )
    detector = Detector.from_config(cfg, device=device)
    weights_path = Path(weights) if weights else Path(cfg.training.save_dir) / "best.pt"
    if weights_path.exists():
        # The template gives structure and shapes only: the skeleton's
        # parameters live on the meta device.
        template = {"params": dict(detector.module.named_parameters())}
        packed = load_checkpoint(weights_path, template, detector.device)
        params = packed["state"]["params"]
        print(f"Loaded checkpoint {weights_path} (epoch {packed['epoch']})")
    else:
        params = detector.init_params(torch.Generator().manual_seed(0))
        print(f"WARNING: no checkpoint at {weights_path}; evaluating fresh init.")
    return evaluate_model(cfg, detector, params)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="config.yaml")
    ap.add_argument("--weights", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("eval_2 needs a CUDA card (torch.cuda.is_available() is False)")
    from .config import load_config

    return evaluate(load_config(args.config), args.weights)


if __name__ == "__main__":
    main()
