"""Plain float32 train step: forward over the window, the detection loss
of its last frame, the gradient, the global-norm clip and AdamW at the
OneCycle rate, as the program's configuration states them.

AdamW: b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
corrected, decoupled weight decay added to the update before the rate
multiplies it. The clip scales by ``max_norm / norm`` only when ``norm >=
max_norm``. OneCycle: two cosine segments, start peak / 25, end start /
1e4, the boundary ``floor(pct_start * total)`` taken in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .loss import loss_sums
from .model import F32, ModelShape, Numerics, forward, preprocess

B1, B2, EPS = 0.9, 0.999, 1e-8


def onecycle_lr(step: int, total: float, peak: float, pct_start: float) -> float:
    total = max(float(total), 1.0)
    s1 = float(np.floor(np.float32(pct_start) * np.float32(total)))
    init = peak / 25.0
    final = init / 1e4
    if step < s1:
        f = min(max(step / max(s1, 1.0), 0.0), 1.0)
        return init + (peak - init) * 0.5 * (1.0 - math.cos(math.pi * f))
    f = min(max((step - s1) / max(total - s1, 1.0), 0.0), 1.0)
    return peak + (final - peak) * 0.5 * (1.0 - math.cos(math.pi * f))


def loss_and_grads(params: dict, batch: dict, shape: ModelShape, gains, num: Numerics = F32,
                   chunk: int | None = None):
    """(loss, {name: gradient}) of one batch of the window, computed in
    chunks of ``chunk`` windows whose gradients add up (the loss's
    normaliser, the target sum, is summed over the chunks first)."""
    images, labels, mask = batch["images"], batch["labels"], batch["label_mask"]
    n = images.shape[0]
    chunk = chunk or n
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    total_sum, target_sum = 0.0, 0.0
    for i in range(0, n, chunk):
        maps, _ = forward(leaves, preprocess(images[i:i + chunk]), None, shape, num)
        s, t = loss_sums(maps, labels[i:i + chunk], mask[i:i + chunk], shape.num_classes,
                         shape.reg_max, gains)
        got = torch.autograd.grad(s, list(leaves.values()), allow_unused=True)
        for k, g in zip(leaves, got):
            if g is not None:
                grads[k] += g
        total_sum += s.detach().double()
        target_sum += t.detach().double()
    scale = n / max(float(target_sum), 1.0)
    for g in grads.values():
        g.mul_(scale)
    return float(total_sum) * scale, grads


class AdamW:
    """Clip -> AdamW on flat dicts; ``step`` updates params in place and
    keeps the per-leaf norms of the clipped gradient it applied.
    ``state``: (mu, nu, count) to start from, zeros and 0 by default."""

    def __init__(self, params: dict, weight_decay: float, clip: float, sched: tuple,
                 state: tuple | None = None):
        if state is None:
            self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
            self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
            self.count = 0
        else:
            mu, nu, self.count = state
            self.mu = {k: mu[k].float().clone() for k in params}
            self.nu = {k: nu[k].float().clone() for k in params}
        self.wd, self.clip, self.sched = weight_decay, clip, sched
        self.clipped_norms = None

    @torch.no_grad()
    def step(self, params: dict, grads: dict):
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
        scale = 1.0 if float(norm) < self.clip else self.clip / float(norm)
        lr = onecycle_lr(self.count, *self.sched)
        self.count += 1
        c1, c2 = 1 - B1 ** self.count, 1 - B2 ** self.count
        norms = []
        for k, p in params.items():
            g = grads[k] * scale
            norms.append(g.double().norm())
            self.mu[k].mul_(B1).add_(g, alpha=1 - B1)
            self.nu[k].mul_(B2).addcmul_(g, g, value=1 - B2)
            upd = (self.mu[k] / c1) / ((self.nu[k] / c2).sqrt() + EPS)
            p.add_(upd + self.wd * p, alpha=-lr)
        self.clipped_norms = torch.stack(norms)


def run_steps(params: dict, batches: list, shape: ModelShape, train_cfg: dict, n_steps: int,
              num: Numerics = F32, chunk: int | None = None, opt_state: tuple | None = None):
    """``n_steps`` train steps from ``params`` (updated in place) on
    ``batches``, the optimizer starting from ``opt_state`` ((mu, nu,
    count); zeros by default); returns the per-step losses, the per-leaf
    norms of the first step's clipped gradient and of the per-leaf norms of
    each step's raw gradient (float64 tensors in ``params``' order)."""
    gains = (train_cfg["box"], train_cfg["cls"], train_cfg["dfl"])
    opt = AdamW(params, train_cfg["weight_decay"], train_cfg["grad_clip_norm"],
                (train_cfg["total_steps"], train_cfg["learning_rate"], train_cfg["pct_start"]),
                opt_state)
    losses, first_grad, raw_norms = [], None, []
    for i in range(n_steps):
        loss, grads = loss_and_grads(params, batches[i], shape, gains, num, chunk)
        losses.append(loss)
        raw_norms.append(torch.stack([g.double().norm() for g in grads.values()]))
        opt.step(params, grads)
        if i == 0:
            first_grad = opt.clipped_norms
    return losses, first_grad, raw_norms
