"""Scalar logging with a fixed tag schema.

Tags:
  per batch:  Loss/train_batch, Train_Loss_Components_Batch{box,cls,dfl},
              LearningRate/batch, Loss/val_batch, Val_Loss_Components_Batch
  per epoch:  Loss/train, Loss/val, LearningRate,
              Train_Loss_Components, Val_Loss_Components

Uses tensorboardX when it is installed, else a JSONL writer with the same
tag names (so logs always exist, even in minimal environments).
"""

from __future__ import annotations

import json
import os
from pathlib import Path


class JsonlWriter:
    def __init__(self, log_dir: str):
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        self._f = open(Path(log_dir) / "scalars.jsonl", "a")

    def add_scalar(self, tag, value, step):
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")

    def add_scalars(self, tag, values, step):
        for k, v in values.items():
            self.add_scalar(f"{tag}/{k}", v, step)

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


class NullWriter:
    """No-op writer (a process that must not write event files)."""

    def add_scalar(self, *a, **k):
        pass

    def add_scalars(self, *a, **k):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def make_writer(save_dir: str | Path):
    log_dir = os.path.join(str(save_dir), "runs")
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return JsonlWriter(log_dir)
    return SummaryWriter(log_dir=log_dir)


class MetricsLogger:
    """The tag schema over any writer object."""

    def __init__(self, writer):
        self.writer = writer

    def train_batch(self, metrics: dict, global_step: int) -> None:
        self.writer.add_scalar("Loss/train_batch", metrics["loss"], global_step)
        self.writer.add_scalars(
            "Train_Loss_Components_Batch",
            {
                "box_loss_batch": metrics["box"],
                "cls_loss_batch": metrics["cls"],
                "dfl_loss_batch": metrics["dfl"],
            },
            global_step,
        )
        self.writer.add_scalar("LearningRate/batch", metrics["lr"], global_step)
        if "fg" in metrics:  # TAL foreground-anchor count (observability)
            self.writer.add_scalar("Assign/fg_anchors_batch", metrics["fg"], global_step)

    def val_batch(self, metrics: dict, global_step: int) -> None:
        self.writer.add_scalar("Loss/val_batch", metrics["loss"], global_step)
        self.writer.add_scalars(
            "Val_Loss_Components_Batch",
            {
                "box_loss_batch": metrics["box"],
                "cls_loss_batch": metrics["cls"],
                "dfl_loss_batch": metrics["dfl"],
            },
            global_step,
        )

    def epoch(self, epoch: int, train_loss, val_loss, train_comps, val_comps, lr) -> None:
        self.writer.add_scalar("Loss/train", train_loss, epoch)
        self.writer.add_scalar("Loss/val", val_loss, epoch)
        self.writer.add_scalar("LearningRate", lr, epoch)
        for tag, comps in (("Train_Loss_Components", train_comps),
                           ("Val_Loss_Components", val_comps)):
            self.writer.add_scalars(
                tag,
                {"box_loss": comps[0], "cls_loss": comps[1], "dfl_loss": comps[2]},
                epoch,
            )
