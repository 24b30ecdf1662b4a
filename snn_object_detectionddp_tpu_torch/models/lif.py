"""Leaky integrate-and-fire (LIF) neurons: forward dynamics for inference.

Dynamics per timestep (soft reset):
    v' = decay * v + x
    s  = H(v' - threshold)
    v  = v' - s * threshold            (hard reset: v = v' * (1 - s))

The membrane is fp32; spikes come back in the current's dtype. The
normalize+LIF stage of every spiking block goes through
:func:`run_affine_lif_tb`, which picks its implementation by the tensor's
device: the hand-written CUDA kernel (kernels/affine_lif.py) for a CUDA
tensor, :func:`affine_lif_tb_reference` for a CPU tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LIFParams(NamedTuple):
    """Static LIF neuron constants (config: model.spike). Defaults match
    ``config.SpikeConfig``."""

    threshold: float = 1.0
    decay: float = 0.05
    surrogate_slope: float = 4.0
    reset: str = "soft"  # "soft" | "hard"


def lif_step(
    v: torch.Tensor, x: torch.Tensor, p: LIFParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """One membrane update. Returns (spikes in x's dtype, v_next in v's
    dtype); the membrane arithmetic runs in v's dtype."""
    v_pre = p.decay * v + x.to(v.dtype)
    s = (v_pre - p.threshold >= 0).to(v.dtype)
    if p.reset == "soft":
        v_next = v_pre - s * p.threshold
    else:  # hard reset to zero
        v_next = v_pre * (1.0 - s)
    return s.to(x.dtype), v_next


def _step_readout(s: torch.Tensor, v_next: torch.Tensor, p: LIFParams) -> torch.Tensor:
    """Per-step continuous readout ``v_next + s*threshold`` (the pre-reset
    membrane under soft reset) — what lets the decoder run on every step of
    a chunk (all-steps streaming)."""
    return v_next + s.to(v_next.dtype) * p.threshold


def affine_lif_tb_reference(
    x4: torch.Tensor,  # (T*B, H, W, C) raw conv outputs, time-major
    a: torch.Tensor,  # (T, B, C) fp32 scale
    b: torch.Tensor,  # (T, B, C) fp32 shift
    p: LIFParams,
    v0: torch.Tensor | None = None,  # (B, H, W, C) fp32
    with_readouts: bool = False,
):
    """Plain PyTorch normalize+LIF: ``cur = x*a + b`` per (t, b, c), then
    the LIF recurrence over T. Same contract as the JAX package's
    ``affine_lif_unrolled_tb``: returns (spikes (T*B, H, W, C) in x's dtype,
    v_final (B, H, W, C) fp32) plus, with ``with_readouts``, the per-step
    readouts (T*B, H, W, C) in x's dtype."""
    t_steps, bsz = a.shape[0], a.shape[1]
    if v0 is None:
        v0 = torch.zeros((bsz,) + tuple(x4.shape[1:]), dtype=torch.float32,
                         device=x4.device)
    v = v0
    spikes, reads = [], []
    for t in range(t_steps):
        xt = x4[t * bsz : (t + 1) * bsz]
        cur = xt.float() * a[t, :, None, None, :] + b[t, :, None, None, :]
        s, v = lif_step(v, cur, p)
        spikes.append(s.to(x4.dtype))
        if with_readouts:
            reads.append(_step_readout(s, v, p).to(x4.dtype))
    if with_readouts:
        return torch.cat(spikes, 0), v, torch.cat(reads, 0)
    return torch.cat(spikes, 0), v


def run_affine_lif_tb(
    x4: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    p: LIFParams,
    v0: torch.Tensor | None = None,
    with_readouts: bool = False,
):
    """Normalize+LIF on the conv's (T*B, H, W, C) output, by device: a CPU
    tensor takes the plain version, any other goes to the CUDA kernel
    (which raises on what it cannot take). Both resets and the readouts
    mode go through the kernel."""
    if x4.device.type == "cpu":
        return affine_lif_tb_reference(x4, a, b, p, v0, with_readouts)
    from ..kernels.affine_lif import affine_lif_fwd

    return affine_lif_fwd(x4, a, b, p, v0, with_readouts)
