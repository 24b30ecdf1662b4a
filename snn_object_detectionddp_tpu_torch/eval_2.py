"""Model mAP evaluation from the command line.

    python -m snn_object_detectionddp_tpu_torch.eval_2 --config config.yaml [--weights best.pt]

The port's counterpart of the JAX package's ``eval_2.py``: load ``best.pt``
or the given weights (this package's checkpoint format,
``train/checkpoint.py``, or a flax file of the JAX package such as
``fixtures/hard_nano_ckpt.pt``: ``convert.load_weights``), rebuild the
seeded validation split, run the recurrent model, NMS (conf 0.001, iou
0.6, 300 detections) and print the DetMetrics results.
With no checkpoint it warns and evaluates a fresh initialisation. Runs on
the card; the config is read without PyYAML. Launched by torchrun on N
processes, each evaluates its share of the windows on ``cuda:LOCAL_RANK``
and the results cover all of them (evals/validator.py); with
``mesh.tensor: k`` the processes form a ``N/k x k`` mesh and each group of
k shares its windows' forward channel-sharded; with ``mesh.spatial: s`` a
``N/s x s`` mesh, each group of s sharing its windows' forward by rows.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from .convert import load_weights
from .evals.validator import evaluate_model
from .models.detector import Detector, set_tf32_policy
from .parallel.mesh import (
    make_mesh,
    maybe_init_distributed,
    process_device,
)


def evaluate(cfg, weights: str | None = None, device: str | torch.device = "cuda") -> dict:
    """Evaluate ``weights`` (default ``<save_dir>/best.pt``) on the
    validation split that ``cfg`` names; returns the results dict. In a
    process group of more than one process the evaluation is split over a
    ``data x tensor`` or ``data x spatial`` mesh (``mesh.data`` x
    ``mesh.tensor`` or ``mesh.spatial``)."""
    detector = Detector.from_config(cfg, device=device)
    mesh = make_mesh(cfg.mesh.data, spatial=cfg.mesh.spatial, tensor=cfg.mesh.tensor)
    weights_path = Path(weights) if weights else Path(cfg.training.save_dir) / "best.pt"
    if weights_path.exists():
        # a checkpoint of this package or a flax file of the JAX package
        params = load_weights(detector, weights_path)
    else:
        params = detector.init_params(torch.Generator().manual_seed(0))
        print(f"WARNING: no checkpoint at {weights_path}; evaluating fresh init.")
    several = mesh.size > 1 or mesh.tensor > 1 or mesh.spatial > 1
    return evaluate_model(cfg, detector, params, mesh=mesh if several else None)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="config.yaml")
    ap.add_argument("--weights", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("eval_2 needs a CUDA card (torch.cuda.is_available() is False)")
    from .config import load_config

    cfg = load_config(args.config)
    set_tf32_policy(cfg.runtime.precision)
    maybe_init_distributed(cfg)
    return evaluate(cfg, args.weights, device=process_device())


if __name__ == "__main__":
    main()
