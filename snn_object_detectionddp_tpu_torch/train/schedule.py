"""OneCycle learning-rate schedule, as a host-side function of the step.

Two cosine-eased segments with the ``torch.optim.lr_scheduler.OneCycleLR``
division conventions (start = peak / 25, end = start / 1e4): the rate
rises over the first ``floor(pct_start * total_steps)`` steps and anneals
over the rest. The constants are arguments, not closure state: the train
state carries them (train/step.py::init_state), so a resumed run continues
the schedule it was saved with.
"""

from __future__ import annotations

import math

import numpy as np

DIV_FACTOR = 25.0
FINAL_DIV_FACTOR = 1e4


def onecycle_lr(step, total_steps, peak, pct_start) -> float:
    """OneCycle learning rate at ``step`` (a Python float)."""
    step = float(step)
    total_steps = max(float(total_steps), 1.0)
    peak = float(peak)
    # The segment boundary is taken in fp32, as the JAX package computes it
    # from its fp32 schedule constants: in fp64 a product such as 0.3 * 10
    # can floor to the other side of an integer.
    s1 = float(np.floor(np.float32(pct_start) * np.float32(total_steps)))
    init = peak / DIV_FACTOR
    final = init / FINAL_DIV_FACTOR
    if step < s1:
        f1 = min(max(step / max(s1, 1.0), 0.0), 1.0)
        return init + (peak - init) * 0.5 * (1.0 - math.cos(math.pi * f1))
    f2 = min(max((step - s1) / max(total_steps - s1, 1.0), 0.0), 1.0)
    return peak + (final - peak) * 0.5 * (1.0 - math.cos(math.pi * f2))
