"""Build and load the hand-written sources under ``csrc/``.

Each source becomes one shared library with a plain C interface, built
into ``build/kernels/`` at first use (a few seconds) and loaded with
``ctypes``: a CUDA source (``.cu``) by ``nvcc`` for ``sm_90a``, a host C++
source (``.cpp``: the PNG decoder of ``data/native.py``, the raster
primitives of ``data/raster.py``) by the host C++ compiler (``$CXX``, else
``g++``), without fused multiply-add contraction so that its float
arithmetic is the one the source spells out, and linked with the system
libraries ``LINK_FLAGS`` names for it (the PNG decoder: zlib and threads).
The library's name carries a hash of the source, of the headers it
includes from ``csrc/`` and of the compiler and link flags, so an edited
source is rebuilt and a stale library is never loaded.
Nothing is fetched or prebuilt: the repository's sources are the only
input.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-ffp-contract=off")
# Headers under csrc/ that the CUDA sources include: part of their hash.
HEADERS = ("lif_common.cuh",)
SOURCES = ("affine_lif.cu", "lif_scan.cu", "token_lstm.cu", "png_decode.cpp", "raster.cpp")
# Link flags of a host source, after the source on the command line.
LINK_FLAGS = {"png_decode.cpp": ("-pthread", "-lz")}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the LIF kernels cannot be built")


def cxx() -> str:
    found = shutil.which(os.environ.get("CXX") or "g++")
    if found is None:
        raise RuntimeError("no host C++ compiler found (set CXX): the host sources cannot be built")
    return found


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` if this version of it has not been built
    yet; returns the library's path."""
    src = CSRC / source
    if src.suffix == ".cu":
        compiler, flags, headers = nvcc(), NVCC_FLAGS, HEADERS
    else:
        compiler, flags, headers = cxx(), CXX_FLAGS, ()
    link = LINK_FLAGS.get(source, ())
    digest = hashlib.sha256(
        src.read_bytes() + b"".join((CSRC / h).read_bytes() for h in headers)
        + " ".join(flags + link).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), str(src), *link]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{Path(compiler).name} failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    return out


def build_all() -> dict[str, float]:
    """Compile every source, one compiler process each, all started
    together; returns the seconds each source took (about 0 when this
    version of it was built before)."""

    def timed(source):
        t0 = time.perf_counter()
        build(source)
        return source, time.perf_counter() - t0

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(pool.map(timed, SOURCES))


def load(source: str, declare) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first when needed.
    ``declare(lib)`` sets the argument types of its entry points; it runs
    once, before any other thread can see the library."""
    with _lock:
        if source not in _libs:
            lib = ctypes.CDLL(str(build(source)))
            declare(lib)
            _libs[source] = lib
        return _libs[source]


def launch(lib: ctypes.CDLL, counts: dict, name: str, device, *args) -> None:
    """Call the C entry point ``name`` of ``lib`` on PyTorch's current
    stream of ``device``; raise on a refused launch, add one to
    ``counts[name]`` for an accepted one."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    counts[name] += 1
