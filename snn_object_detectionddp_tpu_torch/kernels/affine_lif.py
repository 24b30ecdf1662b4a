"""Wrapper of the hand-written CUDA normalize+LIF forward kernel.

The kernel (csrc/affine_lif.cu) replaces the JAX package's Pallas kernel
``kernels/affine_lif_pallas.py::_fwd_kernel``: it reads the conv output
once, applies the per-(t, b, c) GroupNorm affine, runs the whole T loop
with the fp32 membrane in registers, and writes spikes, v_final and,
optionally, the per-step readouts. It is bound by memory bytes.

Build: ``nvcc`` compiles the source into a shared library with a plain C
interface under ``build/kernels/`` at first use (a few seconds), named by
the source's hash so an edited source is rebuilt; ``ctypes`` loads it.
The plain version of the same function is
``models/lif.py::affine_lif_tb_reference``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ..models.lif import LIFParams

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "affine_lif.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the kernel since the last reset_launch_count(): incremented
# once per launch, nowhere else.
launch_count = 0

_lib = None
_build_lock = threading.Lock()


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the LIF kernel cannot be built")


def build() -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"libaffine_lif_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: concurrent builders race harmlessly
    return out


def _load():
    global _lib
    with _build_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.affine_lif_fwd
            vp, i64 = ctypes.c_void_p, ctypes.c_int64
            fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, i64, i64, i64, i64,
                           ctypes.c_float, ctypes.c_float, ctypes.c_int,
                           ctypes.c_int, vp]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def affine_lif_fwd(
    x4: torch.Tensor,  # (T*B, H, W, C) bf16/f32, time-major, contiguous
    a: torch.Tensor,  # (T, B, C) fp32
    b: torch.Tensor,  # (T, B, C) fp32
    p: LIFParams,
    v0: torch.Tensor | None = None,  # (B, H, W, C) fp32
    with_readouts: bool = False,
):
    """Launch the kernel. Returns (spikes, v_final) or, with
    ``with_readouts``, (spikes, v_final, readouts) — the contract of
    ``models/lif.py::affine_lif_tb_reference``. Raises on any input the
    kernel does not take (a tensor off the card included)."""
    global launch_count
    if x4.device.type != "cuda":
        raise ValueError(f"affine_lif_fwd needs CUDA tensors, got {x4.device}")
    if x4.dtype not in _DTYPE_CODES:
        raise ValueError(f"affine_lif_fwd takes bf16/f32 x, got {x4.dtype}")
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
    for name, tns in (("a", a), ("b", b)):
        if tns.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32, got {tns.dtype}")
    for name, tns in (("x", x4), ("a", a), ("b", b), ("v0", v0)):
        if tns.device != x4.device:
            raise ValueError(f"{name} is on {tns.device}, x on {x4.device}")
        if not tns.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if p.reset not in ("soft", "hard"):
        raise ValueError(f"unknown reset '{p.reset}'")

    lib = _load()
    s = torch.empty_like(x4)
    vfin = torch.empty_like(v0)
    reads = torch.empty_like(x4) if with_readouts else None
    if v0.numel():
        with torch.cuda.device(x4.device):
            stream = torch.cuda.current_stream(x4.device).cuda_stream
            err = lib.affine_lif_fwd(
                x4.data_ptr(), a.data_ptr(), b.data_ptr(), v0.data_ptr(),
                s.data_ptr(), vfin.data_ptr(),
                reads.data_ptr() if reads is not None else None,
                t_steps, bsz, h * w, c, float(p.decay), float(p.threshold),
                int(p.reset == "hard"), _DTYPE_CODES[x4.dtype], stream,
            )
        if err != 0:
            raise RuntimeError(f"affine_lif_fwd launch failed: CUDA error {err}")
        launch_count += 1
    if with_readouts:
        return s, vfin, reads
    return s, vfin
