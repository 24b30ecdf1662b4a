"""Wrappers of the hand-written CUDA normalize+LIF kernels.

The kernels (csrc/affine_lif.cu) replace the JAX package's Pallas kernels
of ``kernels/affine_lif_pallas.py``:

- ``affine_lif_fwd`` (``_fwd_kernel``): reads the conv output once, applies
  the per-(t, b, c) GroupNorm affine, runs the whole T loop with the fp32
  membrane in registers, and writes spikes, v_final and, optionally, the
  per-step readouts.
- ``affine_lif_fwd_res`` (``_fwd_res_kernel``): the same forward, also
  storing the pre-reset membrane of every step rounded to x's dtype — the
  residual of the backward.
- ``affine_lif_bwd`` (``_bwd_kernel``): reverse-time SuperSpike BPTT giving
  g_x, g_v0 and the affine gradients da, db. The sums over pixels cross
  thread blocks; the kernel writes per-block partial rows in a fixed order
  (no atomics) and the wrapper folds them with one ``sum(0)``.

All three are bound by memory bytes. :class:`AffineLIF` ties the last two
into a ``torch.autograd.Function``; models/lif.py::run_affine_lif_tb picks
between it and the inference forward.

Build: kernels/build.py compiles the source with ``nvcc`` into a shared
library with a plain C interface under ``build/kernels/`` at first use (a
few seconds), named by the source's hash so an edited source is rebuilt;
``ctypes`` loads it.
The plain versions of the same functions are in models/lif.py
(``affine_lif_tb_reference``, ``affine_lif_forward_reference``,
``affine_lif_backward_reference``).
"""

from __future__ import annotations

import ctypes

import torch

from ..models.lif import LIFParams, backward_cotangents
from . import build as _build

SOURCE = "affine_lif.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

KERNELS = ("affine_lif_fwd", "affine_lif_fwd_res", "affine_lif_bwd")
# Launches of each kernel since the last reset_launch_counts(): a count
# goes up by one where its kernel is launched, and nowhere else.
launch_counts = dict.fromkeys(KERNELS, 0)
# Pixels per thread of the backward kernel (BWD_PPT in the source; checked
# against the built library when it is loaded).
BWD_PIXELS_PER_THREAD = 4


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    vp, i64, f32, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int
    fwd_args = [vp] * 7 + [i64] * 4 + [f32, f32, i32, i32, vp]
    lib.affine_lif_fwd.argtypes = fwd_args
    lib.affine_lif_fwd_res.argtypes = fwd_args
    lib.affine_lif_bwd.argtypes = (
        [vp] * 9 + [i64] * 4 + [f32, f32, f32] + [i32] * 5 + [i64, vp]
    )
    lib.affine_lif_bwd_pixels_per_thread.argtypes = []
    for fn in (lib.affine_lif_fwd, lib.affine_lif_fwd_res, lib.affine_lif_bwd,
               lib.affine_lif_bwd_pixels_per_thread):
        fn.restype = ctypes.c_int
    if lib.affine_lif_bwd_pixels_per_thread() != BWD_PIXELS_PER_THREAD:
        raise RuntimeError("kernel library and wrapper disagree on BWD_PPT")


def _check_forward_inputs(name, x4, a, b, p, v0):
    """Raise on any input the forward kernels do not take (a tensor off
    the card included); returns (T, B, H, W, C) and v0 (zeros when None)."""
    if x4.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {x4.device}")
    if x4.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} takes bf16/f32 x, got {x4.dtype}")
    if x4.ndim != 4 or a.ndim != 3 or b.shape != a.shape:
        raise ValueError(
            f"expected x (T*B, H, W, C), a/b (T, B, C); got {tuple(x4.shape)}, "
            f"{tuple(a.shape)}, {tuple(b.shape)}"
        )
    t_steps, bsz, c = a.shape
    tb, h, w, cx = x4.shape
    if tb != t_steps * bsz or cx != c:
        raise ValueError(
            f"x {tuple(x4.shape)} does not match a/b {tuple(a.shape)}"
        )
    if v0 is None:
        v0 = torch.zeros((bsz, h, w, c), dtype=torch.float32, device=x4.device)
    if v0.shape != (bsz, h, w, c) or v0.dtype != torch.float32:
        raise ValueError(f"v0 must be fp32 {(bsz, h, w, c)}, got {v0.dtype} {tuple(v0.shape)}")
    for nm, tns in (("a", a), ("b", b)):
        if tns.dtype != torch.float32:
            raise ValueError(f"{nm} must be fp32, got {tns.dtype}")
    for nm, tns in (("x", x4), ("a", a), ("b", b), ("v0", v0)):
        if tns.device != x4.device:
            raise ValueError(f"{nm} is on {tns.device}, x on {x4.device}")
        if not tns.is_contiguous():
            raise ValueError(f"{nm} must be contiguous")
    if p.reset not in ("soft", "hard"):
        raise ValueError(f"unknown reset '{p.reset}'")
    return (t_steps, bsz, h, w, c), v0


def _launch(name: str, device: torch.device, *args) -> None:
    """Call one kernel's C entry point on PyTorch's current stream of
    ``device``; raise on a refused launch, count an accepted one."""
    _build.launch(_build.load(SOURCE, _declare), launch_counts, name, device, *args)


def affine_lif_fwd(
    x4: torch.Tensor,  # (T*B, H, W, C) bf16/f32, time-major, contiguous
    a: torch.Tensor,  # (T, B, C) fp32
    b: torch.Tensor,  # (T, B, C) fp32
    p: LIFParams,
    v0: torch.Tensor | None = None,  # (B, H, W, C) fp32
    with_readouts: bool = False,
):
    """Launch the inference forward. Returns (spikes, v_final) or, with
    ``with_readouts``, (spikes, v_final, readouts) — the contract of
    ``models/lif.py::affine_lif_tb_reference``. Raises on any input the
    kernel does not take."""
    (t_steps, bsz, h, w, c), v0 = _check_forward_inputs("affine_lif_fwd", x4, a, b, p, v0)
    s = torch.empty_like(x4)
    vfin = torch.empty_like(v0)
    reads = torch.empty_like(x4) if with_readouts else None
    if v0.numel():
        _launch(
            "affine_lif_fwd", x4.device,
            x4.data_ptr(), a.data_ptr(), b.data_ptr(), v0.data_ptr(),
            s.data_ptr(), vfin.data_ptr(),
            reads.data_ptr() if reads is not None else None,
            t_steps, bsz, h * w, c, float(p.decay), float(p.threshold),
            int(p.reset == "hard"), _DTYPE_CODES[x4.dtype],
        )
    if with_readouts:
        return s, vfin, reads
    return s, vfin


def affine_lif_fwd_res(
    x4: torch.Tensor, a: torch.Tensor, b: torch.Tensor, p: LIFParams,
    v0: torch.Tensor | None = None,
):
    """Launch the residual-saving forward. Returns (spikes, v_pre, v_final):
    ``v_pre`` (T*B, H, W, C) is the pre-reset membrane of every step in x's
    dtype. Same input contract as :func:`affine_lif_fwd`."""
    (t_steps, bsz, h, w, c), v0 = _check_forward_inputs("affine_lif_fwd_res", x4, a, b, p, v0)
    s = torch.empty_like(x4)
    vpre = torch.empty_like(x4)
    vfin = torch.empty_like(v0)
    if v0.numel():
        _launch(
            "affine_lif_fwd_res", x4.device,
            x4.data_ptr(), a.data_ptr(), b.data_ptr(), v0.data_ptr(),
            s.data_ptr(), vpre.data_ptr(), vfin.data_ptr(),
            t_steps, bsz, h * w, c, float(p.decay), float(p.threshold),
            int(p.reset == "hard"), _DTYPE_CODES[x4.dtype],
        )
    return s, vpre, vfin


def bwd_plan(hw: int, c: int, dtype: torch.dtype, aligned: bool) -> tuple[int, int, int, int]:
    """Thread-block shape of the backward kernel for one (H*W, C) and
    dtype: (vec, cvt, ny, n_parts). A thread owns ``vec`` consecutive
    channels (16 bytes of x when C divides and the pointers are 32-byte
    aligned, else 1); a block is ``cvt`` channel vectors by ``ny`` pixel
    lanes (up to 256 threads, the same thread -> channel map for every
    pixel), each thread walking BWD_PIXELS_PER_THREAD pixels; ``n_parts``
    blocks cover the H*W pixels of one sample, each writing one partial
    da/db row per step."""
    wide = 8 if dtype == torch.bfloat16 else 4
    vec = wide if (aligned and c % wide == 0) else 1
    cvt = max(1, min(c // vec, 128))
    ny = max(1, 256 // cvt)
    per_block = ny * BWD_PIXELS_PER_THREAD
    return vec, cvt, ny, max(1, -(-hw // per_block))


def affine_lif_bwd(
    vpre4: torch.Tensor,  # (T*B, H, W, C) x's dtype: residual of the forward
    x4: torch.Tensor,  # (T*B, H, W, C)
    a: torch.Tensor,  # (T, B, C) fp32
    g_s: torch.Tensor,  # (T*B, H, W, C) x's dtype
    g_vfin: torch.Tensor,  # (B, H, W, C) fp32
    p: LIFParams,
):
    """Launch the backward. Returns (g_x in x's dtype, g_a, g_b (T, B, C)
    fp32, g_v0 fp32) — the contract of
    ``models/lif.py::affine_lif_backward_reference``."""
    if x4.device.type != "cuda":
        raise ValueError(f"affine_lif_bwd needs CUDA tensors, got {x4.device}")
    if x4.dtype not in _DTYPE_CODES:
        raise ValueError(f"affine_lif_bwd takes bf16/f32 x, got {x4.dtype}")
    if x4.ndim != 4 or a.ndim != 3 or a.dtype != torch.float32:
        raise ValueError(f"expected x (T*B, H, W, C), a (T, B, C) fp32; got "
                         f"{tuple(x4.shape)}, {a.dtype} {tuple(a.shape)}")
    t_steps, bsz, c = a.shape
    tb, h, w, cx = x4.shape
    if tb != t_steps * bsz or cx != c:
        raise ValueError(f"x {tuple(x4.shape)} does not match a {tuple(a.shape)}")
    for nm, tns in (("vpre", vpre4), ("g_s", g_s)):
        if tns.shape != x4.shape or tns.dtype != x4.dtype:
            raise ValueError(f"{nm} must be {x4.dtype} {tuple(x4.shape)}, got "
                             f"{tns.dtype} {tuple(tns.shape)}")
    if g_vfin.shape != (bsz, h, w, c) or g_vfin.dtype != torch.float32:
        raise ValueError(f"g_vfin must be fp32 {(bsz, h, w, c)}, got "
                         f"{g_vfin.dtype} {tuple(g_vfin.shape)}")
    tensors = (("vpre", vpre4), ("x", x4), ("a", a), ("g_s", g_s), ("g_vfin", g_vfin))
    for nm, tns in tensors:
        if tns.device != x4.device:
            raise ValueError(f"{nm} is on {tns.device}, x on {x4.device}")
        if not tns.is_contiguous():
            raise ValueError(f"{nm} must be contiguous")
    if p.reset not in ("soft", "hard"):
        raise ValueError(f"unknown reset '{p.reset}'")

    g_x = torch.empty_like(x4)
    g_v0 = torch.empty_like(g_vfin)
    aligned = all(t.data_ptr() % 32 == 0 for _, t in tensors) and \
        g_x.data_ptr() % 32 == 0 and g_v0.data_ptr() % 32 == 0
    vec, cvt, ny, n_parts = bwd_plan(h * w, c, x4.dtype, aligned)
    da_part = torch.empty((n_parts, t_steps, bsz, c), dtype=torch.float32, device=x4.device)
    db_part = torch.empty_like(da_part)
    if g_vfin.numel():
        _launch(
            "affine_lif_bwd", x4.device,
            vpre4.data_ptr(), x4.data_ptr(), g_s.data_ptr(), a.data_ptr(),
            g_vfin.data_ptr(), g_x.data_ptr(), g_v0.data_ptr(),
            da_part.data_ptr(), db_part.data_ptr(),
            t_steps, bsz, h * w, c, float(p.decay), float(p.threshold),
            float(p.surrogate_slope), int(p.reset == "hard"), _DTYPE_CODES[x4.dtype],
            vec, cvt, ny, n_parts,
        )
    else:
        da_part.zero_()
        db_part.zero_()
    # Stage 2 of the da/db reduction: fold the blocks' partial rows.
    return g_x, da_part.sum(0), db_part.sum(0), g_v0


class AffineLIF(torch.autograd.Function):
    """Differentiable normalize+LIF on the card: the forward launches
    ``affine_lif_fwd_res`` and saves (v_pre, x, a); the backward launches
    ``affine_lif_bwd``. ``a`` and ``b`` stay ordinary autograd functions
    of the conv output and the GroupNorm parameters, so the gradient of
    the statistics composes by the chain rule."""

    @staticmethod
    def forward(ctx, x4, a, b, v0, p: LIFParams):
        s, vpre, vfin = affine_lif_fwd_res(x4, a, b, p, v0)
        ctx.save_for_backward(vpre, x4, a)
        ctx.p = p
        return s, vfin

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_s, g_vfin):
        vpre, x4, a = ctx.saved_tensors
        g_s, g_vfin = backward_cotangents(x4, (a.shape[1],) + tuple(x4.shape[1:]), g_s, g_vfin)
        g_x, g_a, g_b, g_v0 = affine_lif_bwd(vpre, x4, a, g_s, g_vfin, ctx.p)
        return g_x, g_a, g_b, g_v0, None
