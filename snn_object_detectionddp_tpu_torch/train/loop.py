"""Training orchestration: epochs, validation, checkpointing, logging.

The host side only moves batches and logs; all math lives in the step
functions (train/step.py). Step k's metrics are fetched one iteration LATE
— after step k+1 has been enqueued — so the blocking device-to-host copy
never sits between a step and the next batch's host preparation and upload
(the progress display therefore lags one step).

Data-parallel runs (one process per card, parallel/mesh.py): the metrics
are global-batch values, identical on every process, so every process
makes the same best / latest decisions and keeps its collectives in
lockstep, while only rank 0 writes event files, spike rates and
checkpoints (other processes get a ``NullWriter``).

FSDP runs (``make_step_fns(..., fsdp=True)``): the train state is sharded,
so after each epoch's train steps every process joins one gather
(``fns.gather_state``) and validation, the rank-0 spike-rate pass, the
best-state snapshot and the checkpoint writes read that whole state: rank
0 writes the same file format as an unsharded run.

Spatial runs (a ``data x spatial`` mesh): the ranks of a spatial group see
the same batches and compute the same metrics; the spike-rate pass runs on
every rank of data row 0 (each on its rows), and rank 0 writes the rates.

A loader is any sized iterable of batch dicts: ``images`` (B, T, H, W, 3)
uint8, ``labels`` (B, M, 5), ``label_mask`` (B, M), optionally
``sample_mask`` (B,); numpy arrays or tensors.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..data.encoding import preprocess_video
from ..parallel.mesh import is_main_process
from ..utils.logging import MetricsLogger, NullWriter, make_writer
from ..utils.pipelining import DelayedFetch
from .checkpoint import AsyncCheckpointer, tree_map
from .step import TrainStepFns


def _progress(loader, desc: str, total: int):
    """tqdm when it is installed, else the bare loader."""
    try:
        from tqdm import tqdm
    except ImportError:
        return loader
    return tqdm(loader, desc=desc, total=total)


def _host(metrics: dict) -> dict:
    """Metrics dict of 0-d tensors and floats -> Python floats, with one
    device-to-host copy."""
    keys = list(metrics)
    dev = next((v.device for v in metrics.values() if isinstance(v, torch.Tensor)), "cpu")
    vals = torch.stack([
        torch.as_tensor(metrics[k], dtype=torch.float32, device=dev).detach().reshape(())
        for k in keys
    ])
    return dict(zip(keys, vals.tolist()))


def _run_epoch(step_fn, loader, log_fn, desc: str, first_step: int):
    total, comps, steps = 0.0, np.zeros(3), len(loader)
    pbar = _progress(loader, desc, steps)

    def drain(metrics, batch_idx):
        nonlocal total, comps
        m = _host(metrics)
        total += m["loss"]
        comps += np.array([m["box"], m["cls"], m["dfl"]])
        if hasattr(pbar, "set_postfix"):
            pbar.set_postfix(loss=f"{m['loss']:.4f}")
        log_fn(m, first_step + batch_idx)

    fetch = DelayedFetch(drain)  # one-step-delayed (module docstring)
    first_batch = None
    for batch_idx, batch in enumerate(pbar):
        if first_batch is None:
            first_batch = batch
        fetch.push(step_fn(batch), batch_idx)
    fetch.flush()
    return total / max(steps, 1), comps / max(steps, 1), first_batch


def train_one_epoch(state, fns: TrainStepFns, loader, logger: MetricsLogger, epoch: int):
    """Returns (state, avg_loss, avg_components)."""
    holder = [state]

    def step(batch):
        holder[0], metrics = fns.train_step(holder[0], batch)
        return metrics

    loss, comps, _ = _run_epoch(step, loader, logger.train_batch, "Training",
                                epoch * len(loader))
    return holder[0], loss, comps


def validate_one_epoch(params, fns: TrainStepFns, loader, logger: MetricsLogger, epoch: int):
    """Returns (avg_loss, avg_components, first_batch). The first batch is
    handed back so callers (spike-rate observability) can reuse it instead
    of starting another pass over the loader."""
    return _run_epoch(lambda batch: fns.eval_step(params, batch), loader,
                      logger.val_batch, "Validation", epoch * len(loader))


def train_loop(
    state,
    fns: TrainStepFns,
    schedule,
    train_loader,
    val_loader,
    cfg,
    save_dir: str | Path,
    start_epoch: int = 0,
    best_val_loss: float = float("inf"),
    detector=None,
) -> dict:
    save_dir = Path(save_dir)
    main = is_main_process()
    if main:
        save_dir.mkdir(parents=True, exist_ok=True)
    writer = make_writer(save_dir) if main else NullWriter()
    logger = MetricsLogger(writer)
    ckptr = AsyncCheckpointer()

    epochs = cfg.training.epochs
    best_snap = None  # (snapshotted state, epoch) pending a best.pt write
    for epoch in range(start_epoch, epochs):
        print(f"\n--- Epoch {epoch + 1}/{epochs} ---")
        state, train_loss, train_comps = train_one_epoch(state, fns, train_loader, logger, epoch)
        print(f"Average Training Loss: {train_loss}")

        # The whole state on every process (FSDP; the state itself
        # otherwise): the readers below run at the same point on all ranks.
        whole = fns.gather_state(state)
        val_loss, val_comps, first_val_batch = validate_one_epoch(
            whole["params"], fns, val_loader, logger, epoch
        )
        print(f"Average Validation Loss: {val_loss}")
        logger.epoch(epoch, train_loss, val_loss, train_comps, val_comps,
                     schedule(state["step"]))

        # SNN observability: per-layer firing rates on one val batch,
        # reusing the batch validation already fetched. Data rank 0 only
        # (rank 0, or its spatial group, whose ranks run their rows
        # together); rank 0's writer keeps them.
        mesh = fns.mesh
        if ((mesh is None or mesh.rank == 0) and detector is not None
                and first_val_batch is not None):
            images = torch.as_tensor(first_val_batch["images"]).to(detector.device)
            frames = preprocess_video(images, dtype=detector.dtype)
            for name, rate in detector.spike_rates(whole["params"], frames, mesh=mesh).items():
                writer.add_scalar(f"SpikeRates/{name}", rate, epoch)

        # val_loss is the global loss, the same on every process: every
        # process takes the same branch.
        if val_loss < best_val_loss:
            best_val_loss = val_loss
            # Exact best state, cloned on the device (the next train step
            # updates the live state in place); written out on the next
            # scheduled write, so best.pt fidelity does not depend on the
            # write cadence.
            if main:
                best_snap = (tree_map(lambda t: t.detach().clone(), whole), epoch)
            print(f"New best model (epoch {epoch + 1}), val loss {best_val_loss:.4f}")

        # Checkpoint writes every `save_every_epochs` (0 = final epoch
        # only). Async: the device-to-host copy must not stall training.
        cadence = getattr(cfg.training, "save_every_epochs", 1)
        if main and (epoch == epochs - 1 or (cadence and (epoch + 1) % cadence == 0)):
            latest = save_dir / "latest.pt"
            ckptr.save(whole, epoch, best_val_loss, latest)
            if best_snap is not None:
                snap_state, snap_epoch = best_snap
                ckptr.wait()
                ckptr.save(snap_state, snap_epoch, best_val_loss, save_dir / "best.pt")
                best_snap = None
                print(f"Best checkpoint written to {save_dir / 'best.pt'}")
            print(f"Saved latest model checkpoint to {latest}")
        del whole

    ckptr.wait()
    writer.flush()
    writer.close()
    print("\nTraining finished!")
    return state
