"""Config-driven train / test dispatch from the command line.

    python -m snn_object_detectionddp_tpu_torch.main --config config.yaml

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m snn_object_detectionddp_tpu_torch.main --config config.yaml

The port's counterpart of the JAX package's ``main.py``: ``mode: train``
builds the DSEC index, the seeded sequence split (and the debug subset), a
shuffled train loader that drops a trailing partial batch and a padded
validation loader, and trains through ``train/loop.py`` with checkpoints
under ``training.save_dir`` (``resume_training`` continues from
``training.weights_path``); ``runtime.debug_nans`` makes it raise at the
first operator that returns a NaN (utils/debug.py). ``mode: visualize``
draws the detections on the test split into ``<save_dir>/visualizations``
(viz/overlay.py; the label text needs OpenCV). ``mode: test`` and ``mode:
eval`` run the mAP evaluation of :mod:`.eval_2`. The config is read
without PyYAML (utils/yaml_subset.py).

Data parallelism: launched by torchrun (or with ``mesh.coordinator`` /
``num_processes`` / ``process_id``, as the JAX package is), every process
runs on ``cuda:LOCAL_RANK``, feeds its own shard of the sample lists and
``training.batch_size / world`` samples a step, and rank 0 writes the
checkpoints (parallel/mesh.py).

Not ported, each raising with the ROADMAP item that ports it: FSDP,
spatial and tensor parallelism (``mesh.fsdp``, ``mesh.spatial``,
``mesh.tensor``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from .data.dsec import DSECIndex, apply_train_debug, train_val_split
from .data.pipeline import BatchLoader
from .parallel.mesh import (
    host_shard_indices,
    is_main_process,
    local_batch_size,
    make_mesh,
    maybe_init_distributed,
    pad_batch_to_devices,
    process_device,
    refuse_unported_axes,
)
from .train.checkpoint import load_backbone_params, resume_or_init
from .utils.debug import nan_debugging
from .train.loop import train_loop
from .train.param_groups import make_grouped_optimizer
from .train.step import (
    init_state,
    make_optimizer,
    make_step_fns,
    module_frozen_mask,
)


def train_code(cfg, detector) -> dict:
    """Train ``detector`` on the DSEC directory that ``cfg`` names; returns
    the final train state. With ``runtime.debug_nans`` the first operator
    (or hand kernel) that returns a NaN raises FloatingPointError."""
    refuse_unported_axes(cfg.mesh, train=True)
    with nan_debugging(cfg.runtime.debug_nans):
        return _train(cfg, detector)


def _train(cfg, detector) -> dict:
    mesh = make_mesh(cfg.mesh.data)
    save_dir = Path(cfg.training.save_dir)
    if is_main_process():
        save_dir.mkdir(parents=True, exist_ok=True)

    index = DSECIndex(cfg, "train")
    train_idx, val_idx = train_val_split(index, seed=cfg.training.seed)
    train_idx, val_idx = apply_train_debug(train_idx, val_idx, cfg.debug_train)
    # Every process feeds its own shard of the sample lists.
    train_idx, val_idx = host_shard_indices(train_idx), host_shard_indices(val_idx)

    tr = cfg.training
    # The batch axis tiles over the data mesh.
    n_dev, bs = mesh.size, tr.batch_size
    if bs % n_dev:
        bs = pad_batch_to_devices(bs, n_dev)
        print(f"Rounding batch_size up to {bs} (multiple of {n_dev} devices)")
    loader_kw = dict(batch_size=local_batch_size(bs), max_boxes=cfg.model.max_boxes,
                     num_threads=tr.num_workers, prefetch=cfg.runtime.prefetch)
    train_loader = BatchLoader(index, train_idx, shuffle=True, seed=tr.seed, drop_last=True,
                               **loader_kw)
    val_loader = BatchLoader(index, val_idx, shuffle=False, **loader_kw)
    print(f"Total samples: {len(index)}. Train: {len(train_idx)}. Val: {len(val_idx)}.")

    total_steps = len(train_loader) * tr.epochs
    opt_kw = dict(weight_decay=tr.weight_decay, grad_clip_norm=tr.grad_clip_norm,
                  pct_start=tr.pct_start)
    # The skeleton's parameters (meta tensors): names and shapes for the
    # optimizer groups and the checkpoint template, no memory.
    meta_params = dict(detector.module.named_parameters())
    if cfg.model.freeze_backbone:
        if tr.param_groups:
            raise ValueError(
                "model.freeze_backbone cannot combine with training.param_groups "
                "(pick one optimizer structure)"
            )
        tx, schedule = make_optimizer(tr.learning_rate, total_steps,
                                      frozen_mask=module_frozen_mask("backbone"), **opt_kw)
        print("Backbone frozen: zero updates + no weight decay on backbone.")
    elif tr.param_groups:
        tx, schedule = make_grouped_optimizer(meta_params, tr.learning_rate, total_steps, **opt_kw)
    else:
        tx, schedule = make_optimizer(tr.learning_rate, total_steps, **opt_kw)
    fns = make_step_fns(
        detector, tx, schedule, remat=tr.remat, remat_chunk=tr.remat_chunk or None,
        grad_accum=tr.grad_accum_steps or 1, remat_policy=tr.remat_policy, mesh=mesh,
    )

    def fresh_init():
        params = detector.init_params(torch.Generator().manual_seed(tr.seed))
        if cfg.model.backbone_init:
            # Fresh starts only: a resumed checkpoint already carries its
            # trained backbone.
            params = load_backbone_params(cfg.model.backbone_init, params)
        return init_state(params, tx, schedule)

    state, start_epoch, best = resume_or_init(
        cfg, init_state(meta_params, tx, schedule), init_fn=fresh_init, device=detector.device
    )
    if any(t.is_meta for t in state["opt_state"]["mu"].values()):
        # The checkpoint's optimizer state did not fit this optimizer: it
        # restored the parameters only, so the moments start fresh.
        state["opt_state"] = tx.init(state["params"])
    return train_loop(state, fns, schedule, train_loader, val_loader, cfg, save_dir,
                      start_epoch=start_epoch, best_val_loss=best, detector=detector)


def visualize_code(cfg, detector) -> list[str]:
    """Draw the detections of ``<save_dir>/best.pt`` (a checkpoint of this
    package or a flax file) on the test split into
    ``<save_dir>/visualizations``; returns the saved paths. Raises naming
    cv2.putText, before it reads anything, where OpenCV is missing."""
    from .convert import load_packed_weights
    from .data.classes import DSEC_DET_CLASSES
    from .viz.overlay import _put_label, run_visualization

    _put_label()
    save_dir = Path(cfg.training.save_dir)
    weights_path = save_dir / "best.pt"
    output_dir = save_dir / "visualizations"
    print(f"Saving visualizations to {output_dir}")
    packed = load_packed_weights(detector, weights_path)
    print(f"Model with val loss {packed['best_val_loss']} loaded successfully for visualization.")
    return run_visualization(cfg, detector, packed["params"], output_dir,
                             class_names=DSEC_DET_CLASSES[: cfg.model.num_classes])


def run(cfg, detector):
    """Dispatch on ``cfg.mode`` with the caller's detector."""
    if cfg.mode == "train":
        return train_code(cfg, detector)
    if cfg.mode == "visualize":
        return visualize_code(cfg, detector)
    if cfg.mode in ("test", "eval"):
        from .eval_2 import evaluate

        return evaluate(cfg, device=detector.device)
    raise ValueError(f"unknown mode '{cfg.mode}' (train | visualize | test | eval)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="config.yaml")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("main needs a CUDA card (torch.cuda.is_available() is False)")
    from .config import load_config
    from .models.detector import Detector, set_tf32_policy

    cfg = load_config(args.config)
    set_tf32_policy(cfg.runtime.precision)
    # A distributed launch joins its process group before anything else
    # touches the card (the JAX main.py's order).
    maybe_init_distributed(cfg)
    return run(cfg, Detector.from_config(cfg, device=process_device()))


if __name__ == "__main__":
    main()
