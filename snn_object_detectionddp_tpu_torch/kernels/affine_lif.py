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
  thread blocks: every block writes partial rows into a scratch, and the
  last block of a (sample, channel tile) to finish adds them in a fixed
  order inside the same launch, so da/db come back as the kernel wrote
  them, bitwise equal from launch to launch.

All three are bound by memory bytes and share one geometry, planned here
in Python (:func:`fwd_plan`, :func:`bwd_plan`): a block owns a narrow tile
of channels and a run of pixels of one sample. :class:`AffineLIF` ties the
last two into a ``torch.autograd.Function``; models/lif.py::run_affine_lif_tb
picks between it and the inference forward. The model reaches the three
through their operators in kernels/ops.py, which call these wrappers on a
CUDA tensor.

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
import functools
from typing import NamedTuple

import torch

from ..models.lif import LIFParams, backward_cotangents
from ..utils.debug import check_kernel_outputs
from . import build as _build
from . import ops

SOURCE = "affine_lif.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

KERNELS = ("affine_lif_fwd", "affine_lif_fwd_res", "affine_lif_bwd")
# Launches of each kernel since the last reset_launch_counts(): a count
# goes up by one where its kernel is launched, and nowhere else.
launch_counts = dict.fromkeys(KERNELS, 0)
# Calls on an empty problem (a spatial rank that owns no row of a map):
# no grid is launched, and the call is counted here instead.
skipped_empty = dict.fromkeys(KERNELS, 0)

THREADS = 128  # per block: small enough that the late-stage shapes fill 132 SMs
BWD_THREADS = 256  # the backward's, where that still leaves BWD_MIN_BLOCKS blocks
BWD_MIN_BLOCKS = 132
SEGMENT_BYTES = 128  # of one pixel that a block's channel tile spans, at most
MIN_SEGMENT_BYTES = 32  # one sector: narrower exact tiles give way to one masked tile
PIXELS_PER_THREAD = (4, 2, 1)  # tried in this order
# A thread takes more than one pixel only while this many threads remain:
# about one resident wave of the card (132 SMs x 1,024 threads).
FILL_THREADS = 132 * 1024
MAX_SLOT_BYTES = 32 * 1024  # shared memory of the backward's per-step sums
# Steps of its three input streams that a backward thread keeps in flight
# (RING_DEPTH in the source: its entry point refuses a plan made for another).
RING_DEPTH = 2
# Partial rows that one block adds at a level of the backward's tree; up to
# twice as many when that makes the tree a single level.
FOLD_FAN = 32
MAX_GRID_X, MAX_GRID_Y = 2**31 - 1, 65535


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0
        skipped_empty[name] = 0


class LaunchPlan(NamedTuple):
    """How one (B, H*W, C) problem is cut into thread blocks. Thread ``i``
    of a block owns channel vector ``i % cvt`` of the block's channel tile
    at the pixels ``(run * ppt + j) * ny + i // cvt`` for ``j < ppt``, with
    ``ny = threads // cvt``; block ``k`` of sample ``b`` (grid
    ``(c_tiles * n_runs, B)``) owns tile ``k % c_tiles`` and run
    ``k // c_tiles``. Channels past C and pixels past H*W are masked."""

    vec: int  # channels per thread: 16 bytes of x, or 1 on the scalar path
    cvt: int  # channel vectors per block
    ppt: int  # pixels per thread
    threads: int
    c_tiles: int
    n_runs: int
    # Backward only: steps whose sums are parked in shared memory between
    # two barriers, that memory's size, and the scratch the kernel writes.
    t_chunk: int = 0
    smem_bytes: int = 0
    fan: int = 0  # partial rows that one block adds at a level of the tree
    fold_rows: tuple = ()  # partial rows of a (sample, tile) at each level of the tree
    scratch_floats: int = 0  # 2 (da, db) x sum(fold_rows) x T x B x C
    n_tickets: int = 0  # one per group of fan rows, level, sample and tile

    @property
    def ny(self) -> int:
        return self.threads // self.cvt

    def blocks(self, bsz: int) -> int:
        return self.c_tiles * self.n_runs * bsz


def _channel_tile(cv: int, vec_bytes: int, pow2: bool) -> int:
    """Channel vectors per block for a row of ``cv`` vectors of
    ``vec_bytes``: the widest tile of at most SEGMENT_BYTES (and 32
    vectors) that divides ``cv`` — a power of two where the backward's
    warp shuffles need one — unless that leaves segments under
    MIN_SEGMENT_BYTES (a C with no such divisor: no main-path shape); then
    one wider tile whose last lanes are masked."""
    target = max(1, min(32, SEGMENT_BYTES // vec_bytes))
    if pow2:
        exact = next(p for p in (32, 16, 8, 4, 2, 1) if p <= target and cv % p == 0)
        masked = min(target, 1 << (cv - 1).bit_length())
    else:
        exact = next(d for d in range(min(cv, target), 0, -1) if cv % d == 0)
        masked = min(cv, target)
    if exact == cv or exact * vec_bytes >= MIN_SEGMENT_BYTES:
        return exact
    return masked


def _plan(bsz: int, hw: int, c: int, dtype: torch.dtype, aligned: bool, pow2: bool,
          threads: int, pixels: tuple) -> LaunchPlan:
    itemsize = torch.finfo(dtype).bits // 8
    wide = 16 // itemsize
    vec = wide if (aligned and c % wide == 0) else 1
    cv = c // vec
    cvt = _channel_tile(cv, vec * itemsize, pow2)
    c_tiles = -(-cv // cvt)
    ny = threads // cvt
    slots = bsz * hw * c_tiles * cvt  # threads at one pixel each
    # The scalar path is built for one pixel per thread only.
    ppt = next(p for p in pixels if p == 1 or (vec > 1 and slots // p >= FILL_THREADS))
    return LaunchPlan(vec, cvt, ppt, threads, c_tiles, max(1, -(-hw // (ny * ppt))))


@functools.lru_cache(maxsize=256)  # a model asks for the same few plans at every launch
def fwd_plan(bsz: int, hw: int, c: int, dtype: torch.dtype, aligned: bool) -> LaunchPlan:
    """The launch plan of both forward kernels for x (T*B, H, W, C) of
    ``dtype``; ``aligned``: every pointer is 32-byte aligned."""
    return _plan(bsz, hw, c, dtype, aligned, False, THREADS, PIXELS_PER_THREAD)


@functools.lru_cache(maxsize=256)
def bwd_plan(t_steps: int, bsz: int, hw: int, c: int, dtype: torch.dtype,
             aligned: bool) -> LaunchPlan:
    """The launch plan of the backward kernel: the forward's geometry with
    a power-of-two channel tile and one pixel a thread, plus its shared
    memory (the ring of asynchronous copies on the vector path and the
    per-step sums) and the partial-row scratch the kernel writes."""
    plan = _plan(bsz, hw, c, dtype, aligned, True, BWD_THREADS, (1,))
    if plan.blocks(bsz) < BWD_MIN_BLOCKS:
        plan = _plan(bsz, hw, c, dtype, aligned, True, THREADS, (1,))
    slot_bytes = 4 * (plan.threads // 32) * 2 * plan.vec * plan.cvt  # one step's sums
    t_chunk = max(1, min(t_steps, MAX_SLOT_BYTES // slot_bytes))
    ring_bytes = 16 * RING_DEPTH * 3 * plan.threads if plan.vec > 1 else 0
    # The tree that adds the partial rows: fan rows of a level make one
    # row of the next, down to a single row, which is da/db itself.
    fan = max(2, plan.n_runs) if plan.n_runs <= 2 * FOLD_FAN else FOLD_FAN
    rows = [plan.n_runs]
    while -(-rows[-1] // fan) > 1:
        rows.append(-(-rows[-1] // fan))
    return plan._replace(
        t_chunk=t_chunk, smem_bytes=ring_bytes + t_chunk * slot_bytes, fan=fan,
        fold_rows=tuple(rows), scratch_floats=2 * sum(rows) * t_steps * bsz * c,
        n_tickets=bsz * plan.c_tiles * sum(-(-r // fan) for r in rows),
    )


def _check_grid(name: str, plan: LaunchPlan, t_steps: int, bsz: int, hw: int, c: int) -> None:
    """Raise on sizes the kernels' 32-bit offsets or CUDA's grid cannot hold."""
    if bsz * hw * c >= 2**31 or t_steps * bsz * c >= 2**31:
        raise ValueError(f"{name}: B*H*W*C = {bsz * hw * c} does not fit 32-bit offsets")
    if plan.c_tiles * plan.n_runs > MAX_GRID_X or bsz > MAX_GRID_Y:
        raise ValueError(f"{name}: grid {(plan.c_tiles * plan.n_runs, bsz)} exceeds CUDA's limits")


def _declare(lib: ctypes.CDLL) -> None:
    vp, i64, f32, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int
    fwd_args = [vp] * 7 + [i64] * 4 + [f32, f32] + [i32] * 6 + [vp]
    lib.affine_lif_fwd.argtypes = fwd_args
    lib.affine_lif_fwd_res.argtypes = fwd_args
    lib.affine_lif_bwd.argtypes = (
        [vp] * 11 + [i64] * 4 + [f32, f32, f32] + [i32] * 7 + [i64, i32, i64, vp]
    )
    lib.affine_lif_empty_launch.argtypes = [i32, i32, vp]
    for fn in (lib.affine_lif_fwd, lib.affine_lif_fwd_res, lib.affine_lif_bwd,
               lib.affine_lif_empty_launch):
        fn.restype = ctypes.c_int


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


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 32 == 0 for t in tensors if t is not None)


def _forward(name, x4, a, b, p, v0, outs, dims):
    """Plan and launch one of the two forward kernels; ``outs`` are its
    output tensors in the C entry point's order (None: not asked for)."""
    t_steps, bsz, h, w, c = dims
    plan = fwd_plan(bsz, h * w, c, x4.dtype, _aligned(x4, a, b, v0, *outs))
    _check_grid(name, plan, t_steps, bsz, h * w, c)
    _launch(
        name, x4.device,
        x4.data_ptr(), a.data_ptr(), b.data_ptr(), v0.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in outs),
        t_steps, bsz, h * w, c, float(p.decay), float(p.threshold),
        int(p.reset == "hard"), _DTYPE_CODES[x4.dtype],
        plan.vec, plan.cvt, plan.ppt, plan.threads,
    )


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
    dims, v0 = _check_forward_inputs("affine_lif_fwd", x4, a, b, p, v0)
    s = torch.empty_like(x4)
    vfin = torch.empty_like(v0)
    reads = torch.empty_like(x4) if with_readouts else None
    if v0.numel():
        _forward("affine_lif_fwd", x4, a, b, p, v0, (s, vfin, reads), dims)
    else:
        skipped_empty["affine_lif_fwd"] += 1
    check_kernel_outputs("affine_lif_fwd", s, vfin, reads)
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
    dims, v0 = _check_forward_inputs("affine_lif_fwd_res", x4, a, b, p, v0)
    s = torch.empty_like(x4)
    vpre = torch.empty_like(x4)
    vfin = torch.empty_like(v0)
    if v0.numel():
        _forward("affine_lif_fwd_res", x4, a, b, p, v0, (s, vpre, vfin), dims)
    else:
        skipped_empty["affine_lif_fwd_res"] += 1
    check_kernel_outputs("affine_lif_fwd_res", s, vpre, vfin)
    return s, vpre, vfin


# The backward's scratch, one per (device, stream): [tickets, partial rows].
# Launches on one stream run one after another, so they share it; the
# tickets are zero between launches (the kernel resets what it counted).
_bwd_scratch: dict[tuple[int, int], list[torch.Tensor]] = {}


def _scratch_key(device: torch.device) -> tuple[int, int]:
    with torch.cuda.device(device):
        return torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream


def _scratch_for(device: torch.device, plan: LaunchPlan) -> list[torch.Tensor]:
    """The (tickets, partial rows) scratch of ``device``'s current stream,
    grown to what ``plan`` says the kernel writes."""
    key = _scratch_key(device)
    with torch.cuda.device(device):
        held = _bwd_scratch.get(key)
        if held is None:
            held = _bwd_scratch[key] = [
                torch.zeros(max(plan.n_tickets, 1024), dtype=torch.int32, device=device),
                torch.empty(plan.scratch_floats, dtype=torch.float32, device=device),
            ]
        if held[0].numel() < plan.n_tickets:
            held[0] = torch.zeros(plan.n_tickets, dtype=torch.int32, device=device)
        if held[1].numel() < plan.scratch_floats:
            held[1] = torch.empty(plan.scratch_floats, dtype=torch.float32, device=device)
    return held


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
    if not g_vfin.numel():
        skipped_empty["affine_lif_bwd"] += 1
        return g_x, torch.zeros_like(a), torch.zeros_like(a), g_v0
    g_a = torch.empty_like(a)
    g_b = torch.empty_like(a)
    plan = bwd_plan(t_steps, bsz, h * w, c, x4.dtype,
                    _aligned(*(t for _, t in tensors), g_x, g_v0, g_a, g_b))
    _check_grid("affine_lif_bwd", plan, t_steps, bsz, h * w, c)
    tickets, part = _scratch_for(x4.device, plan)
    try:
        _launch(
            "affine_lif_bwd", x4.device,
            vpre4.data_ptr(), x4.data_ptr(), g_s.data_ptr(), a.data_ptr(),
            g_vfin.data_ptr(), g_x.data_ptr(), g_v0.data_ptr(),
            g_a.data_ptr(), g_b.data_ptr(), part.data_ptr(), tickets.data_ptr(),
            t_steps, bsz, h * w, c, float(p.decay), float(p.threshold),
            float(p.surrogate_slope), int(p.reset == "hard"), _DTYPE_CODES[x4.dtype],
            plan.vec, plan.cvt, plan.threads, plan.t_chunk, plan.fan, plan.n_runs,
            RING_DEPTH, plan.smem_bytes,
        )
    except RuntimeError:
        # A launch that failed may have left tickets counted: the stream's
        # next backward starts from a fresh, zeroed scratch.
        _bwd_scratch.pop(_scratch_key(x4.device), None)
        raise
    check_kernel_outputs("affine_lif_bwd", g_x, g_a, g_b, g_v0)
    return g_x, g_a, g_b, g_v0


def empty_launch(device: torch.device, blocks: int = 1, threads: int = THREADS) -> None:
    """Launch the library's do-nothing kernel on ``device``'s current
    stream: the time one launch costs the card, for timing scripts. It is
    no kernel of any path and is not counted."""
    _build.launch(_build.load(SOURCE, _declare), {"affine_lif_empty_launch": 0},
                  "affine_lif_empty_launch", device, blocks, threads)


class AffineLIF(torch.autograd.Function):
    """Differentiable normalize+LIF on the card: the forward calls the
    operator ``snn_torch::affine_lif_fwd_res`` (kernels/ops.py) and saves
    (v_pre, x, a); the backward calls ``snn_torch::affine_lif_bwd``.
    ``a`` and ``b`` stay ordinary autograd functions of the conv output
    and the GroupNorm parameters, so the gradient of the statistics
    composes by the chain rule."""

    @staticmethod
    def forward(ctx, x4, a, b, v0, p: LIFParams):
        s, vpre, vfin = ops.affine_lif_fwd_res(x4, a, b, v0, *p)
        ctx.save_for_backward(vpre, x4, a)
        ctx.p = p
        return s, vfin

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_s, g_vfin):
        vpre, x4, a = ctx.saved_tensors
        g_s, g_vfin = backward_cotangents(x4, (a.shape[1],) + tuple(x4.shape[1:]), g_s, g_vfin)
        g_x, g_a, g_b, g_v0 = ops.affine_lif_bwd(vpre, x4, a, g_s, g_vfin, *ctx.p)
        return g_x, g_a, g_b, g_v0, None
