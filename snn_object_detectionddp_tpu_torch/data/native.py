"""ctypes bridge to the compiled PNG row filters (``csrc/png_unfilter.cpp``).

The host library is built at first use by ``kernels/build.py`` with the
host C++ compiler and loaded once. ``ctypes`` releases the interpreter
lock for the call, so decoder threads run it side by side. A failed build
raises: there is no fallback to the numpy version.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..kernels import build

SOURCE = "png_unfilter.cpp"


def _declare(lib: ctypes.CDLL) -> None:
    lib.snn_png_unfilter.restype = ctypes.c_int
    lib.snn_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]


def unfilter(buf: np.ndarray, h: int, row_bytes: int, bpp: int, name: str = "<buffer>") -> None:
    """Undo the row filters of ``buf`` in place: ``h`` rows of a filter-type
    byte followed by ``row_bytes`` filtered bytes, ``bpp`` bytes a pixel.
    Raises ``ValueError`` (naming ``name``) on an unknown filter type."""
    if buf.dtype != np.uint8 or not buf.flags.c_contiguous or not buf.flags.writeable:
        raise ValueError("unfilter needs a writable C-contiguous uint8 buffer")
    if buf.size != h * (row_bytes + 1):
        raise ValueError(f"{name}: {buf.size} bytes for {h} rows of {row_bytes} + 1")
    lib = build.load(SOURCE, _declare)
    rc = lib.snn_png_unfilter(buf.ctypes.data, h, row_bytes, bpp)
    if rc < 0:
        raise ValueError(f"{name}: bad unfilter arguments (h={h}, row_bytes={row_bytes}, bpp={bpp})")
    if rc > 0:
        raise ValueError(f"{name}: row {rc - 1} has unknown PNG filter type {buf[(rc - 1) * (row_bytes + 1)]}")
