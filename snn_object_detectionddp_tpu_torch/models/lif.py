"""Leaky integrate-and-fire (LIF) neurons with surrogate-gradient BPTT.

Dynamics per timestep (soft reset):
    v' = decay * v + x
    s  = H(v' - threshold)
    v  = v' - s * threshold            (hard reset: v = v' * (1 - s))

The spike is a Heaviside step whose backward pass uses the SuperSpike
fast-sigmoid surrogate ``dS/dv = 1 / (slope * |v - threshold| + 1)^2``.
The membrane is fp32; spikes come back in the current's dtype.

The normalize+LIF stage of every spiking block goes through
:func:`run_affine_lif_tb`, which picks its implementation by the tensor's
device and by whether a gradient is needed: on a CUDA tensor the
hand-written kernels (forward, forward with the ``v_pre`` residual,
reverse-time backward), on a CPU tensor the plain versions in this module
(:func:`affine_lif_tb_reference` and the functions it is built from). The
kernels are the operators of kernels/ops.py (``torch.ops.snn_torch``),
whose CPU implementations are these plain versions; the inference forward
calls its operator on either device, so ``torch.export`` records one
operator per spiking block. Kernel and plain version compute the same
function: under a gradient both save the pre-reset membrane rounded to
x's dtype and run the same reverse-time recurrence on it.

The plain LIF scan over any (T, ...) currents (no affine) goes through
:func:`run_lif` in the same way: the kernels of kernels/lif.py on a CUDA
tensor, :func:`lif_forward_reference` / :func:`lif_backward_reference` on
a CPU tensor.
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


def surrogate_grad(v_shifted: torch.Tensor, slope: float) -> torch.Tensor:
    """The SuperSpike surrogate derivative 1 / (slope*|v| + 1)^2."""
    return 1.0 / torch.square(slope * v_shifted.abs() + 1.0)


class _Spike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v_shifted: torch.Tensor, slope: float):
        ctx.save_for_backward(v_shifted)
        ctx.slope = slope
        return (v_shifted >= 0).to(v_shifted.dtype)

    @staticmethod
    def backward(ctx, g):
        (v_shifted,) = ctx.saved_tensors
        return g * surrogate_grad(v_shifted, ctx.slope), None


def spike(v_shifted: torch.Tensor, slope: float = 4.0) -> torch.Tensor:
    """Heaviside step H(v - theta): 1.0 where ``v_shifted >= 0`` else 0.0,
    with the SuperSpike surrogate as its derivative."""
    return _Spike.apply(v_shifted, slope)


def lif_step(
    v: torch.Tensor, x: torch.Tensor, p: LIFParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """One membrane update, differentiable through the surrogate. Returns
    (spikes in x's dtype, v_next in v's dtype); the membrane arithmetic
    runs in v's dtype."""
    v_pre = p.decay * v + x.to(v.dtype)
    s = spike(v_pre - p.threshold, p.surrogate_slope)
    if p.reset == "soft":
        v_next = v_pre - s * p.threshold
    else:  # hard reset to zero
        v_next = v_pre * (1.0 - s)
    return s.to(x.dtype), v_next


def lif_scan(
    x_t: torch.Tensor, p: LIFParams, v0: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """LIF dynamics over a leading time axis: (T, ...) currents -> (spikes
    (T, ...), final membrane (...)). ``v0`` is zeros when None. Autograd
    through :func:`lif_step` gives BPTT."""
    if v0 is None:
        v0 = torch.zeros(x_t.shape[1:], dtype=torch.float32, device=x_t.device)
    v, spikes = v0, []
    for t in range(x_t.shape[0]):
        s, v = lif_step(v, x_t[t], p)
        spikes.append(s)
    return torch.stack(spikes), v


def _step_readout(s: torch.Tensor, v_next: torch.Tensor, p: LIFParams) -> torch.Tensor:
    """Per-step continuous readout ``v_next + s*threshold`` (the pre-reset
    membrane under soft reset) — what lets the decoder run on every step of
    a chunk (all-steps streaming)."""
    return v_next + s.to(v_next.dtype) * p.threshold


def _zero_membrane(x4: torch.Tensor, bsz: int) -> torch.Tensor:
    return torch.zeros((bsz,) + tuple(x4.shape[1:]), dtype=torch.float32,
                       device=x4.device)


def affine_lif_forward_reference(
    x4: torch.Tensor, a: torch.Tensor, b: torch.Tensor, p: LIFParams,
    v0: torch.Tensor, with_readouts: bool = False, with_vpre: bool = False,
):
    """Plain, gradient-free normalize+LIF forward: ``cur = x*a + b`` per
    (t, b, c), then the LIF recurrence over T. Returns (spikes, v_final,
    readouts or None, v_pre or None); the per-step outputs are
    (T*B, H, W, C) in x's dtype — ``v_pre`` is the pre-reset membrane
    rounded to x's dtype, the residual the backward runs on."""
    t_steps, bsz = a.shape[0], a.shape[1]
    v = v0
    spikes, reads, vpres = [], [], []
    for t in range(t_steps):
        xt = x4[t * bsz : (t + 1) * bsz]
        cur = xt.float() * a[t, :, None, None, :] + b[t, :, None, None, :]
        v_pre = p.decay * v + cur
        s = (v_pre - p.threshold >= 0).float()
        if p.reset == "soft":
            v = v_pre - s * p.threshold
        else:
            v = v_pre * (1.0 - s)
        spikes.append(s.to(x4.dtype))
        if with_readouts:
            reads.append(_step_readout(s, v, p).to(x4.dtype))
        if with_vpre:
            vpres.append(v_pre.to(x4.dtype))
    return (torch.cat(spikes, 0), v,
            torch.cat(reads, 0) if with_readouts else None,
            torch.cat(vpres, 0) if with_vpre else None)


def affine_lif_backward_reference(
    vpre4: torch.Tensor,  # (T*B, H, W, C) x's dtype: saved pre-reset membrane
    x4: torch.Tensor,  # (T*B, H, W, C)
    a: torch.Tensor,  # (T, B, C) fp32
    g_s: torch.Tensor,  # (T*B, H, W, C) x's dtype: cotangent of the spikes
    g_vfin: torch.Tensor,  # (B, H, W, C) fp32: cotangent of v_final
    p: LIFParams,
):
    """Plain reverse-time surrogate BPTT of the normalize+LIF stage.
    Returns (g_x in x's dtype, g_a, g_b (T, B, C) fp32, g_v0 fp32). Under
    hard reset the spike is recomputed from the saved (rounded) ``v_pre``."""
    t_steps, bsz = a.shape[0], a.shape[1]
    gv = g_vfin
    g_x, g_a, g_b = [None] * t_steps, [None] * t_steps, [None] * t_steps
    for t in range(t_steps - 1, -1, -1):
        sl = slice(t * bsz, (t + 1) * bsz)
        v_pre = vpre4[sl].float()
        shifted = v_pre - p.threshold
        sur = surrogate_grad(shifted, p.surrogate_slope)
        if p.reset == "soft":
            dpost = 1.0 - p.threshold * sur
        else:
            dpost = (1.0 - (shifted >= 0).float()) - v_pre * sur
        g_cur = gv * dpost + g_s[sl].float() * sur
        g_x[t] = (g_cur * a[t, :, None, None, :]).to(x4.dtype)
        g_a[t] = (g_cur * x4[sl].float()).sum((1, 2))
        g_b[t] = g_cur.sum((1, 2))
        gv = p.decay * g_cur
    return torch.cat(g_x, 0), torch.stack(g_a), torch.stack(g_b), gv


def backward_cotangents(ctx_x4: torch.Tensor, v_shape, g_s, g_vfin):
    """What autograd hands a normalize+LIF backward, made into what the
    backward takes: a missing cotangent becomes zeros, an expanded or
    strided one is made contiguous, a wrong dtype or device raises."""
    if g_s is None:
        g_s = torch.zeros_like(ctx_x4)
    if g_vfin is None:
        g_vfin = torch.zeros(v_shape, dtype=torch.float32, device=ctx_x4.device)
    if g_s.dtype != ctx_x4.dtype or g_vfin.dtype != torch.float32:
        raise TypeError(
            f"cotangents must be ({ctx_x4.dtype}, float32), got ({g_s.dtype}, {g_vfin.dtype})"
        )
    if g_s.device != ctx_x4.device or g_vfin.device != ctx_x4.device:
        raise ValueError(f"cotangents on {g_s.device}/{g_vfin.device}, x on {ctx_x4.device}")
    return g_s.contiguous(), g_vfin.contiguous()


class _AffineLIFReference(torch.autograd.Function):
    """Differentiable plain normalize+LIF: the CPU counterpart of
    kernels/affine_lif.py::AffineLIF, same residuals, same recurrence."""

    @staticmethod
    def forward(ctx, x4, a, b, v0, p: LIFParams):
        s, vfin, _, vpre = affine_lif_forward_reference(x4, a, b, p, v0, with_vpre=True)
        ctx.save_for_backward(vpre, x4, a)
        ctx.p = p
        return s, vfin

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_s, g_vfin):
        vpre, x4, a = ctx.saved_tensors
        g_s, g_vfin = backward_cotangents(x4, (a.shape[1],) + tuple(x4.shape[1:]), g_s, g_vfin)
        g_x, g_a, g_b, g_v0 = affine_lif_backward_reference(vpre, x4, a, g_s, g_vfin, ctx.p)
        return g_x, g_a, g_b, g_v0, None


def needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    )


def affine_lif_tb_reference(
    x4: torch.Tensor,  # (T*B, H, W, C) raw conv outputs, time-major
    a: torch.Tensor,  # (T, B, C) fp32 scale
    b: torch.Tensor,  # (T, B, C) fp32 shift
    p: LIFParams,
    v0: torch.Tensor | None = None,  # (B, H, W, C) fp32
    with_readouts: bool = False,
):
    """Plain PyTorch normalize+LIF, differentiable. Same contract as the
    JAX package's ``affine_lif_unrolled_tb``: returns (spikes (T*B, H, W, C)
    in x's dtype, v_final (B, H, W, C) fp32) plus, with ``with_readouts``,
    the per-step readouts (T*B, H, W, C) in x's dtype. Readouts under a
    gradient are not implemented (training never asks for them)."""
    if v0 is None:
        v0 = _zero_membrane(x4, a.shape[1])
    if needs_grad(x4, a, b, v0):
        if with_readouts:
            raise NotImplementedError(
                "per-step readouts are not differentiable in this port; run "
                "all_steps forwards under torch.no_grad()"
            )
        return _AffineLIFReference.apply(x4, a, b, v0, p)
    s, v, reads, _ = affine_lif_forward_reference(x4, a, b, p, v0, with_readouts)
    return (s, v, reads) if with_readouts else (s, v)


def run_affine_lif_tb(
    x4: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    p: LIFParams,
    v0: torch.Tensor | None = None,
    with_readouts: bool = False,
):
    """Normalize+LIF on the conv's (T*B, H, W, C) output. Without a
    gradient, on any device, the operator ``snn_torch::affine_lif_fwd``
    (kernels/ops.py: the CUDA kernel on a CUDA tensor, the plain version on
    a CPU tensor; both resets, optional readouts). Under a gradient a CPU
    tensor takes the plain autograd path, any other the residual-saving
    forward and the reverse-time backward (kernels/affine_lif.py::AffineLIF),
    which raise on what they cannot take."""
    grad = needs_grad(x4, a, b, v0)
    if grad and x4.device.type == "cpu":
        return affine_lif_tb_reference(x4, a, b, p, v0, with_readouts)
    if grad and with_readouts:
        raise NotImplementedError(
            "per-step readouts are not differentiable in this port; run "
            "all_steps forwards under torch.no_grad()"
        )
    if v0 is None:
        v0 = _zero_membrane(x4, a.shape[1])
    if grad:
        from ..kernels.affine_lif import AffineLIF

        return AffineLIF.apply(x4, a, b, v0, p)
    from ..kernels import ops

    s, v, reads = ops.affine_lif_fwd(x4, a, b, v0, *p, with_readouts)
    return (s, v, reads) if with_readouts else (s, v)


# ---------------------------------------------------------------------------
# Plain LIF scan on any (T, ...) currents: run_lif and its plain versions
# ---------------------------------------------------------------------------


def lif_forward_reference(
    x_t: torch.Tensor, p: LIFParams, v0: torch.Tensor, with_residuals: bool = False
):
    """Plain, gradient-free LIF scan over the leading time axis, step for
    step what the ``lif_scan_fwd`` / ``lif_scan_fwd_res`` kernels compute.
    Returns (spikes (T, ...) in x's dtype, v_pre (T, ...) rounded to x's
    dtype — None without ``with_residuals`` —, v_final (...) fp32)."""
    v = v0
    spikes, vpres = [], []
    for t in range(x_t.shape[0]):
        v_pre = p.decay * v + x_t[t].float()
        s = (v_pre >= p.threshold).float()
        if p.reset == "soft":
            v = v_pre - s * p.threshold
        else:
            v = v_pre * (1.0 - s)
        spikes.append(s.to(x_t.dtype))
        if with_residuals:
            vpres.append(v_pre.to(x_t.dtype))
    empty = x_t.new_empty(x_t.shape)
    return (torch.stack(spikes) if spikes else empty,
            (torch.stack(vpres) if vpres else empty) if with_residuals else None, v)


def lif_backward_reference(
    v_pre: torch.Tensor,  # (T, ...) x's dtype: saved pre-reset membrane
    g_s: torch.Tensor,  # (T, ...) x's dtype: cotangent of the spikes
    g_vfin: torch.Tensor,  # (...) fp32: cotangent of v_final
    p: LIFParams,
):
    """Plain reverse-time surrogate BPTT of the LIF scan, step for step what
    the ``lif_scan_bwd`` kernel computes. Returns (g_x (T, ...) in x's
    dtype, g_v0 (...) fp32). Under hard reset the spike is recomputed from
    the saved (rounded) ``v_pre``."""
    gv = g_vfin
    g_x = [None] * v_pre.shape[0]
    for t in range(v_pre.shape[0] - 1, -1, -1):
        vp = v_pre[t].float()
        shifted = vp - p.threshold
        sur = surrogate_grad(shifted, p.surrogate_slope)
        if p.reset == "soft":
            dpost = 1.0 - p.threshold * sur
        else:
            dpost = (1.0 - (shifted >= 0).float()) - vp * sur
        g_vpre = gv * dpost + g_s[t].float() * sur
        g_x[t] = g_vpre.to(v_pre.dtype)
        gv = p.decay * g_vpre
    return (torch.stack(g_x) if g_x else v_pre.new_empty(v_pre.shape)), gv


class _LIFScanReference(torch.autograd.Function):
    """Differentiable plain LIF scan: the CPU counterpart of
    kernels/lif.py::LIFScan, same residual, same recurrence."""

    @staticmethod
    def forward(ctx, x_t, v0, p: LIFParams):
        s, vpre, vfin = lif_forward_reference(x_t, p, v0, with_residuals=True)
        ctx.save_for_backward(vpre)
        ctx.p = p
        return s, vfin

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_s, g_vfin):
        (vpre,) = ctx.saved_tensors
        g_s, g_vfin = backward_cotangents(vpre, tuple(vpre.shape[1:]), g_s, g_vfin)
        g_x, g_v0 = lif_backward_reference(vpre, g_s, g_vfin, ctx.p)
        return g_x, g_v0, None


def run_lif(
    x_t: torch.Tensor, p: LIFParams, v0: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """LIF dynamics over the leading time axis of any (T, ...) currents
    (fp32 or bf16): returns (spikes (T, ...) in x's dtype, final membrane
    (...) fp32). ``v0`` is an fp32 membrane of shape (...), zeros when None.

    Without a gradient the operator ``snn_torch::lif_scan_fwd`` runs on any
    device (the CUDA kernel or, on a CPU tensor, the plain version). Under
    a gradient a CPU tensor takes the plain autograd path, any other the
    residual-saving forward with the reverse-time backward
    (kernels/lif.py::LIFScan); the kernels raise on what they cannot take.
    The kernels read a contiguous (T, N) array, so a strided view of
    ``x_t`` or ``v0`` is copied into a contiguous tensor first (one extra
    read and write of it); the plain versions take any strides. Under a gradient both routes
    save ``v_pre`` rounded to x's dtype, so in fp32 the gradients equal
    those of :func:`lif_scan` and in bf16 they carry that rounding."""
    if x_t.ndim < 1:
        raise ValueError("run_lif needs a leading time axis")
    if x_t.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"run_lif takes bf16/f32 currents, got {x_t.dtype}")
    if v0 is None:
        v0 = torch.zeros(x_t.shape[1:], dtype=torch.float32, device=x_t.device)
    if v0.shape != x_t.shape[1:] or v0.dtype != torch.float32:
        raise ValueError(
            f"v0 must be fp32 {tuple(x_t.shape[1:])}, got {v0.dtype} {tuple(v0.shape)}"
        )
    if p.reset not in ("soft", "hard"):
        raise ValueError(f"unknown reset '{p.reset}'")
    grad = needs_grad(x_t, v0)
    if x_t.device.type != "cpu":
        x_t, v0 = x_t.contiguous(), v0.contiguous()
    if not grad:
        from ..kernels import ops

        return ops.lif_scan_fwd(x_t, v0, *p)
    if x_t.device.type == "cpu":
        return _LIFScanReference.apply(x_t, v0, p)
    from ..kernels.lif import LIFScan

    return LIFScan.apply(x_t, v0, p)
