"""Wrappers of the hand-written CUDA plain-LIF-scan kernels.

The kernels (csrc/lif_scan.cu) replace the JAX package's Pallas kernels of
``kernels/lif_pallas.py``:

- ``lif_scan_fwd`` (``_fwd_kernel``): reads the (T, ...) currents once,
  runs the whole T loop with the fp32 membrane in registers, writes the
  spikes and v_final.
- ``lif_scan_fwd_res`` (``_fwd_res_kernel``): the same forward, also
  storing the pre-reset membrane of every step rounded to x's dtype — the
  residual of the backward.
- ``lif_scan_bwd`` (``_bwd_kernel``): reverse-time SuperSpike BPTT giving
  g_x and g_v0; every element is independent.

All three are bound by memory bytes. They take any (T, ...) shape as a
contiguous (T, N) array with no padding and no copy: the launcher picks
the widest vector that keeps every row aligned. :class:`LIFScan` ties the
last two into a ``torch.autograd.Function``; models/lif.py::run_lif picks
between it and the inference forward. The model reaches the three through
their operators in kernels/ops.py, which call these wrappers on a CUDA
tensor.

Build: kernels/build.py compiles the source with ``nvcc`` at first use.
The plain versions of the same functions are in models/lif.py
(``lif_forward_reference``, ``lif_backward_reference``).
"""

from __future__ import annotations

import ctypes

import torch

from ..models.lif import LIFParams, backward_cotangents
from ..utils.debug import check_kernel_outputs
from . import build as _build
from . import ops

SOURCE = "lif_scan.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

KERNELS = ("lif_scan_fwd", "lif_scan_fwd_res", "lif_scan_bwd")
# Launches of each kernel since the last reset_launch_counts(): a count
# goes up by one where its kernel is launched, and nowhere else.
launch_counts = dict.fromkeys(KERNELS, 0)


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    vp, i64, f32, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int
    lib.lif_scan_fwd.argtypes = [vp] * 4 + [i64, i64, f32, f32, i32, i32, vp]
    lib.lif_scan_fwd_res.argtypes = [vp] * 5 + [i64, i64, f32, f32, i32, i32, vp]
    lib.lif_scan_bwd.argtypes = [vp] * 5 + [i64, i64, f32, f32, f32, i32, i32, vp]
    for fn in (lib.lif_scan_fwd, lib.lif_scan_fwd_res, lib.lif_scan_bwd):
        fn.restype = ctypes.c_int


def _launch(name: str, device: torch.device, *args) -> None:
    _build.launch(_build.load(SOURCE, _declare), launch_counts, name, device, *args)


def _check(name: str, p: LIFParams, per_step: dict, state: dict):
    """Raise on any input the kernels do not take (a tensor off the card
    included): ``per_step`` tensors are (T, ...) of one bf16/f32 dtype,
    ``state`` tensors (...) fp32, all contiguous on one CUDA device.
    Returns (T, N)."""
    first_name, first = next(iter(per_step.items()))
    if first.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {first.device}")
    if first.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} takes bf16/f32 {first_name}, got {first.dtype}")
    if first.ndim < 1:
        raise ValueError(f"{first_name} needs a leading time axis")
    for nm, tns in per_step.items():
        if tns.shape != first.shape or tns.dtype != first.dtype:
            raise ValueError(f"{nm} must be {first.dtype} {tuple(first.shape)}, got "
                             f"{tns.dtype} {tuple(tns.shape)}")
    for nm, tns in state.items():
        if tns.shape != first.shape[1:] or tns.dtype != torch.float32:
            raise ValueError(f"{nm} must be fp32 {tuple(first.shape[1:])}, got "
                             f"{tns.dtype} {tuple(tns.shape)}")
    for nm, tns in (*per_step.items(), *state.items()):
        if tns.device != first.device:
            raise ValueError(f"{nm} is on {tns.device}, {first_name} on {first.device}")
        if not tns.is_contiguous():
            raise ValueError(f"{nm} must be contiguous")
    if p.reset not in ("soft", "hard"):
        raise ValueError(f"unknown reset '{p.reset}'")
    t_steps = first.shape[0]
    return t_steps, first.numel() // max(t_steps, 1)


def _zeros_like_state(x_t: torch.Tensor) -> torch.Tensor:
    return torch.zeros(x_t.shape[1:], dtype=torch.float32, device=x_t.device)


def lif_scan_fwd(
    x_t: torch.Tensor,  # (T, ...) bf16/f32, contiguous
    p: LIFParams,
    v0: torch.Tensor | None = None,  # (...) fp32
):
    """Launch the inference forward. Returns (spikes (T, ...) in x's dtype,
    v_final (...) fp32). Raises on any input the kernel does not take."""
    if v0 is None:
        v0 = _zeros_like_state(x_t)
    t_steps, n = _check("lif_scan_fwd", p, {"x": x_t}, {"v0": v0})
    s = torch.empty_like(x_t)
    vfin = torch.empty_like(v0) if t_steps else v0.clone()
    if x_t.numel():
        _launch(
            "lif_scan_fwd", x_t.device,
            x_t.data_ptr(), v0.data_ptr(), s.data_ptr(), vfin.data_ptr(),
            t_steps, n, float(p.decay), float(p.threshold),
            int(p.reset == "hard"), _DTYPE_CODES[x_t.dtype],
        )
    check_kernel_outputs("lif_scan_fwd", s, vfin)
    return s, vfin


def lif_scan_fwd_res(x_t: torch.Tensor, p: LIFParams, v0: torch.Tensor | None = None):
    """Launch the residual-saving forward. Returns (spikes, v_pre, v_final):
    ``v_pre`` (T, ...) is the pre-reset membrane of every step in x's dtype.
    Same input contract as :func:`lif_scan_fwd`."""
    if v0 is None:
        v0 = _zeros_like_state(x_t)
    t_steps, n = _check("lif_scan_fwd_res", p, {"x": x_t}, {"v0": v0})
    s = torch.empty_like(x_t)
    vpre = torch.empty_like(x_t)
    vfin = torch.empty_like(v0) if t_steps else v0.clone()
    if x_t.numel():
        _launch(
            "lif_scan_fwd_res", x_t.device,
            x_t.data_ptr(), v0.data_ptr(), s.data_ptr(), vpre.data_ptr(), vfin.data_ptr(),
            t_steps, n, float(p.decay), float(p.threshold),
            int(p.reset == "hard"), _DTYPE_CODES[x_t.dtype],
        )
    check_kernel_outputs("lif_scan_fwd_res", s, vpre, vfin)
    return s, vpre, vfin


def lif_scan_bwd(
    v_pre: torch.Tensor,  # (T, ...) x's dtype: residual of the forward
    g_s: torch.Tensor,  # (T, ...) x's dtype
    g_vfin: torch.Tensor,  # (...) fp32
    p: LIFParams,
):
    """Launch the backward. Returns (g_x (T, ...) in x's dtype, g_v0 (...)
    fp32) — the contract of ``models/lif.py::lif_backward_reference``."""
    t_steps, n = _check("lif_scan_bwd", p, {"v_pre": v_pre, "g_s": g_s}, {"g_vfin": g_vfin})
    g_x = torch.empty_like(v_pre)
    g_v0 = torch.empty_like(g_vfin) if t_steps else g_vfin.clone()
    if v_pre.numel():
        _launch(
            "lif_scan_bwd", v_pre.device,
            v_pre.data_ptr(), g_s.data_ptr(), g_vfin.data_ptr(), g_x.data_ptr(),
            g_v0.data_ptr(), t_steps, n, float(p.decay), float(p.threshold),
            float(p.surrogate_slope), int(p.reset == "hard"), _DTYPE_CODES[v_pre.dtype],
        )
    check_kernel_outputs("lif_scan_bwd", g_x, g_v0)
    return g_x, g_v0


class LIFScan(torch.autograd.Function):
    """Differentiable LIF scan on the card: the forward calls the operator
    ``snn_torch::lif_scan_fwd_res`` (kernels/ops.py) and saves v_pre; the
    backward calls ``snn_torch::lif_scan_bwd``."""

    @staticmethod
    def forward(ctx, x_t, v0, p: LIFParams):
        s, vpre, vfin = ops.lif_scan_fwd_res(x_t, v0, *p)
        ctx.save_for_backward(vpre)
        ctx.p = p
        return s, vfin

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_s, g_vfin):
        (vpre,) = ctx.saved_tensors
        g_s, g_vfin = backward_cotangents(vpre, tuple(vpre.shape[1:]), g_s, g_vfin)
        g_x, g_v0 = ops.lif_scan_bwd(vpre, g_s, g_vfin, *ctx.p)
        return g_x, g_v0, None
