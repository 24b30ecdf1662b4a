"""Everything a run feeds the program, made from ``--seed``: the weights,
on the device in one draw, and the moving-box frames and their labels.

The same seed gives the same weights and the same frames on every run; the
program and the reference get the same tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.model import ModelShape, param_spec

# The seed is any whole number; torch generators take 64 bits.
_SEED_MASK = (1 << 63) - 1


def host_rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator for one use of the seed."""
    return np.random.default_rng([int(seed) & _SEED_MASK, int(stream)])


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(stream)) & _SEED_MASK)
    return g


def make_weights(shape: ModelShape, seed: int, device, overrides: dict | None = None) -> dict:
    """fp32 parameters of ``param_spec(shape)``: every normal leaf a slice
    of one standard-normal draw on ``device``, scaled by its std; the
    constant leaves filled. ``overrides`` maps a name suffix to a constant
    that replaces the constant of every leaf ending in it."""
    spec = param_spec(shape)
    total = sum(int(np.prod(s)) for _, s, kind, _ in spec if kind == "normal")
    flat = torch.randn(total, generator=device_generator(seed, 1, device), device=device)
    params, offset = {}, 0
    for name, s, kind, value in spec:
        n = int(np.prod(s))
        if kind == "normal":
            params[name] = flat[offset:offset + n].view(s).mul(value)
            offset += n
            continue
        for suffix, v in (overrides or {}).items():
            if name.endswith(suffix):
                value = v
        t = torch.full(s, float(value) if kind == "const" else 0.0, device=device)
        if kind == "forget":
            q = s[0] // 4
            t[q:2 * q] = value
        params[name] = t
    return params


def draw_boxes(rng: np.random.Generator, n_frames: int, h: int, w: int, traffic: dict,
               num_classes: int):
    """Moving boxes over ``n_frames`` frames: a count from
    ``traffic["boxes"]`` ([lo, hi]), each with a class, a colour, a size
    (fractions ``traffic["box_size"]`` of the image side), a start and a
    velocity in px a frame (``traffic["speed"]``), kept inside the image.
    Returns (n, 9) int rows [class, w, h, x0, y0, vx, vy, r, g, b]."""
    lo, hi = traffic["boxes"]
    n = int(rng.integers(lo, hi + 1))
    s_lo, s_hi = traffic["box_size"]
    speed = traffic["speed"]
    bw = rng.integers(int(w * s_lo), int(w * s_hi) + 1, n)
    bh = rng.integers(int(h * s_lo), int(h * s_hi) + 1, n)
    vx = rng.integers(-speed, speed + 1, n)
    vy = rng.integers(-speed, speed + 1, n)
    span = n_frames - 1
    # starts such that every frame's box stays inside the image
    x0 = rng.integers(np.maximum(0, -vx * span), np.maximum(1, w - bw - np.maximum(0, vx * span)))
    y0 = rng.integers(np.maximum(0, -vy * span), np.maximum(1, h - bh - np.maximum(0, vy * span)))
    cls = rng.integers(0, num_classes, n)
    color = rng.integers(96, 256, (n, 3))
    return np.column_stack([cls, bw, bh, x0, y0, vx, vy, color])


def render(boxes: np.ndarray, n_frames: int, h: int, w: int, gen: torch.Generator, device,
           max_boxes: int):
    """Frames (n_frames, H, W, 3) uint8 on ``device``: dark noise with the
    boxes painted in order, and the last frame's labels (max_boxes, 5)
    ``[class, cx, cy, w, h]`` normalised plus their mask."""
    frames = torch.randint(0, 48, (n_frames, h, w, 3), generator=gen, device=device,
                           dtype=torch.uint8)
    labels = np.zeros((max_boxes, 5), np.float32)
    mask = np.zeros(max_boxes, bool)
    for k, (c, bw, bh, x0, y0, vx, vy, r, g, b) in enumerate(boxes):
        color = torch.tensor([r, g, b], dtype=torch.uint8, device=device)
        for t in range(n_frames):
            x, y = x0 + vx * t, y0 + vy * t
            frames[t, y:y + bh, x:x + bw] = color
        if k < max_boxes:
            x, y = x0 + vx * (n_frames - 1), y0 + vy * (n_frames - 1)
            labels[k] = [c, (x + bw / 2) / w, (y + bh / 2) / h, bw / w, bh / h]
            mask[k] = True
    return frames, labels, mask


def train_batch(seed: int, index: int, batch: int, t_steps: int, hw, traffic: dict,
                num_classes: int, max_boxes: int, device) -> dict:
    """One host batch as a loader hands it: images (B, T, H, W, 3) uint8,
    labels (B, max_boxes, 5), label_mask (B, max_boxes), all numpy."""
    h, w = hw
    rng = host_rng(seed, 100 + index)
    gen = device_generator(seed, 100 + index, device)
    images = torch.empty((batch, t_steps, h, w, 3), dtype=torch.uint8, device=device)
    labels = np.zeros((batch, max_boxes, 5), np.float32)
    mask = np.zeros((batch, max_boxes), bool)
    for b in range(batch):
        boxes = draw_boxes(rng, t_steps, h, w, traffic, num_classes)
        images[b], labels[b], mask[b] = render(boxes, t_steps, h, w, gen, device, max_boxes)
    return {"images": images.cpu().numpy(), "labels": labels, "label_mask": mask}


def stream_frames(seed: int, stream: int, n_frames: int, hw, traffic: dict, num_classes: int,
                  device) -> np.ndarray:
    """One camera's looped sequence: (n_frames, H, W, 3) uint8 numpy."""
    h, w = hw
    boxes = draw_boxes(host_rng(seed, 10_000 + stream), n_frames, h, w, traffic, num_classes)
    frames, _, _ = render(boxes, n_frames, h, w, device_generator(seed, 10_000 + stream, device),
                          device, 1)
    return frames.cpu().numpy()
