"""Discriminative learning-rate parameter groups.

A 3-group optimizer split: backbone/U-Net weights at the base learning
rate, detect-head weights at 2x, and biases/norm parameters (1-D leaves)
with no weight decay. Enable with ``training.param_groups: true``.
"""

from __future__ import annotations

from .step import Optimizer, Schedule


def group_of(name: str, leaf) -> str:
    """Classify a parameter by its dotted name.

    - 'no_decay': biases and norm scales/offsets (leaves of at most 1 dim)
    - 'head':     detect-head weights (2x learning rate)
    - 'base':     everything else
    """
    if leaf.ndim <= 1:
        return "no_decay"
    if "head" in name.split("."):
        return "head"
    return "base"


def make_grouped_optimizer(
    params: dict,
    peak_lr: float,
    total_steps: int,
    weight_decay: float = 5e-4,
    grad_clip_norm: float = 10.0,
    pct_start: float = 0.3,
    head_lr_mult: float = 2.0,
):
    """Global-norm clip, then AdamW per group {base, head, no_decay}.
    Returns (tx, schedule) like ``make_optimizer``."""
    settings = {
        "base": (1.0, weight_decay),
        "head": (head_lr_mult, weight_decay),
        "no_decay": (1.0, 0.0),
    }
    groups = {k: settings[group_of(k, v)] for k, v in params.items()}
    tx = Optimizer(weight_decay, grad_clip_norm, groups=groups)
    return tx, Schedule(total_steps, peak_lr, pct_start)
