"""The benchmark's own counts of work: bytes the normalize+LIF kernels
must move and FLOPs of the model, reckoned from a cell's shapes, never
read from the program.

- Bytes (``lif_bytes*``): each input read once and each output written
  once, at the 20 spiking-block shapes of the configuration.
- FLOPs: ``FlopCounterMode`` over the frozen reference on the ``meta``
  device: convolutions and matrix products (and their backward for a
  train step); the LIF, GroupNorm and other elementwise work count
  nothing.
"""

from __future__ import annotations

import functools
import json

import torch

from .reference.model import ModelShape, forward, param_spec


def lif_bytes(n_elem: int, t_steps: int, c: int, bsz: int, readouts: bool, itemsize=2) -> int:
    """A1 (forward): x and s per step, the readouts per step when asked,
    v0 and v_final once, a and b once."""
    per_elem = (2 + int(readouts)) * itemsize * t_steps + 8
    return n_elem * per_elem + 2 * t_steps * bsz * c * 4


def lif_bytes_res(n_elem: int, t_steps: int, c: int, bsz: int, itemsize=2) -> int:
    """A2 (forward saving the residual): x read, s and v_pre written per
    step, v0 and v_final once, a and b once."""
    return n_elem * (3 * itemsize * t_steps + 8) + 2 * t_steps * bsz * c * 4


def lif_bytes_bwd(n_elem: int, t_steps: int, c: int, bsz: int, itemsize=2) -> int:
    """A3 (backward): v_pre, x, g_s read and g_x written per step, g_vfinal
    and g_v0 once, a read and da, db written once."""
    return n_elem * (4 * itemsize * t_steps + 8) + 3 * t_steps * bsz * c * 4


def spiking_shapes(shape: ModelShape) -> list[tuple[int, int, int]]:
    """(H, W, C) of the 20 spiking blocks' outputs, in forward order."""
    (c_stem, c_p3, c_p4, c_p5), depth = shape.channels()
    base = int(shape.width_mult * 128)
    half = lambda hw: (-(-hw[0] // 2), -(-hw[1] // 2))  # noqa: E731
    stem = (shape.image_size[0] // 4, shape.image_size[1] // 4)
    out = [stem + (c_stem,), stem + (2 * c_stem,)]
    hw, sizes = stem, []
    for c in (c_p3, c_p4, c_p5):
        hw = half(hw)
        sizes.append(hw)
        out += [hw + (c,)] * (2 + depth)
    p3, p4, p5 = sizes
    out += [p3 + (base,), half(p3) + (2 * base,), half(p3) + (2 * base,), p4 + (2 * base,),
            half(p4) + (4 * base,), half(p4) + (4 * base,), p5 + (4 * base,),
            half(p5) + (8 * base,), half(p5) + (8 * base,)]
    return out


def lif_train_bytes(shape: ModelShape, t_steps: int, bsz: int) -> int:
    """A2 + A3 bytes of one train step."""
    total = 0
    for h, w, c in spiking_shapes(shape):
        n = bsz * h * w * c
        total += lif_bytes_res(n, t_steps, c, bsz) + lif_bytes_bwd(n, t_steps, c, bsz)
    return total


def lif_serve_bytes(shape: ModelShape, bsz: int) -> int:
    """A1 bytes of one T=1 streaming dispatch of ``bsz`` frames."""
    return sum(lif_bytes(bsz * h * w * c, 1, c, bsz, False) for h, w, c in spiking_shapes(shape))


def _meta_params(shape: ModelShape, grad: bool) -> dict:
    return {name: torch.empty(s, device="meta", requires_grad=grad)
            for name, s, _, _ in param_spec(shape)}


@functools.lru_cache(maxsize=None)
def model_flops(shape_json: str, t_steps: int, bsz: int, backward: bool) -> float:
    """FLOPs of the reference's forward over a (T, B) window, and its
    backward to the parameters when ``backward``, counted on ``meta``.
    ``shape_json`` is the ``ModelShape`` as JSON (hashable)."""
    from torch.utils.flop_counter import FlopCounterMode

    shape = ModelShape(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in json.loads(shape_json).items()})
    h, w = shape.image_size
    params = _meta_params(shape, backward)
    frames = torch.empty((t_steps, bsz, h, w, 3), device="meta")
    with FlopCounterMode(display=False) as counter, torch.set_grad_enabled(backward):
        maps, _ = forward(params, frames, None, shape)
        if backward:
            torch.autograd.grad(sum(m.sum() for m in maps), list(params.values()),
                                allow_unused=True)
    return float(counter.get_total_flops())


def shape_key(shape: ModelShape) -> str:
    return json.dumps(shape.__dict__, sort_keys=True)
