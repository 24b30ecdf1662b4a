"""ctypes bridge to the port's PNG decoder (``csrc/png_decode.cpp``).

The host library is built at first use by ``kernels/build.py`` with the
host C++ compiler, linked with zlib, and loaded once. A failed build
raises: there is no fallback. ``ctypes`` releases the interpreter lock for
each call, so decoding never holds it.

- :func:`decode`: one PNG in memory into an (H, W, 3) uint8 RGB array
  (what :func:`.png.decode_png` and :func:`.png.read_rgb` call);
- :func:`decode_batch`: N files into one (N, H, W, 3) array in one call,
  on a pool of C++ threads (the loader's whole-batch path);
- :func:`unfilter`: the row filters alone, in place.

A failure raises what the plain version (:func:`.png.decode_png_reference`)
raises, in its words, naming the file: ``OSError`` (``FileNotFoundError``
for a missing file) when a file cannot be read, else ``ValueError``.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..kernels import build

SOURCE = "png_decode.cpp"

# csrc/png_decode.cpp::SnnPngCode
(_OS_ERROR, _NOT_PNG, _TRUNCATED, _CRC, _NO_IEND, _BAD_IHDR, _DEPTH, _INTERLACED, _UNSUPPORTED,
 _NO_DATA, _NO_PLTE, _BAD_PLTE, _CORRUPT, _LENGTH, _FILTER, _SIZE, _INTERNAL) = range(1, 18)
_MESSAGES = {
    _NOT_PNG: "not a PNG file",
    _TRUNCATED: "truncated {chunk} chunk",
    _CRC: "CRC mismatch in {chunk} chunk",
    _NO_IEND: "no IEND chunk",
    _BAD_IHDR: "bad IHDR",
    _DEPTH: "{0}-bit PNG is not supported (8-bit only)",
    _INTERLACED: "interlaced PNG is not supported",
    _UNSUPPORTED: "unsupported PNG (colour type {0}, {1}x{2})",
    _NO_DATA: "no IHDR or no IDAT chunk",
    _NO_PLTE: "palette image without a PLTE chunk",
    _BAD_PLTE: "PLTE chunk of {0} bytes is not a multiple of 3",
    _CORRUPT: "corrupt image data ({zlib})",
    _LENGTH: "image data is {0} bytes, {1} expected for {2}x{3} with {4} samples a pixel",
    _FILTER: "row {0} has unknown PNG filter type {1}",
    _SIZE: "frame is {0}x{1}, the batch is {batch}",
}


class _Status(ctypes.Structure):
    """csrc/png_decode.cpp::SnnPngStatus."""

    _fields_ = [("code", ctypes.c_int32), ("index", ctypes.c_int32), ("os_errno", ctypes.c_int32),
                ("chunk", ctypes.c_uint8 * 4), ("args", ctypes.c_int64 * 5),
                ("detail", ctypes.c_char * 128)]


def _declare(lib: ctypes.CDLL) -> None:
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, args in (
        ("snn_png_decode", [ctypes.c_char_p, ctypes.c_long, P, I64, I64, ctypes.POINTER(_Status)]),
        ("snn_png_unfilter", [P, I, I, I]),
        ("snn_decode_batch", [ctypes.POINTER(ctypes.c_char_p), I, P, I, I, I,
                              ctypes.POINTER(_Status)]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = I, args


def _lib() -> ctypes.CDLL:
    return build.load(SOURCE, _declare)


def _error(st: _Status, name: str, batch: str = "") -> Exception:
    """The exception for a failed decode of ``name``."""
    if st.code == _OS_ERROR:
        return OSError(st.os_errno, os.strerror(st.os_errno), name)
    detail = st.detail.decode(errors="replace")
    if st.code == _INTERNAL:
        return MemoryError(f"{name}: {detail}")
    zlib = f"Error {st.args[0]} while decompressing data" + (f": {detail}" if detail else "")
    text = _MESSAGES[st.code].format(*st.args, chunk=bytes(st.chunk).decode(errors="replace"),
                                     zlib=zlib, batch=batch)
    return ValueError(f"{name}: {text}")


def decode(data: bytes, name: str) -> np.ndarray:
    """Decode PNG bytes into a new (H, W, 3) uint8 RGB array; ``name``
    labels the errors."""
    data = bytes(data)
    lib = _lib()
    # The size from the IHDR that opens every PNG; a file whose last IHDR
    # says otherwise is decoded again at the size the decoder reports.
    h = w = 0
    if len(data) >= 24 and data[12:16] == b"IHDR":
        w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")
    st = _Status()
    for _ in range(2):
        out = np.empty((h, w, 3), np.uint8)
        if lib.snn_png_decode(data, len(data), out.ctypes.data, h, w, ctypes.byref(st)) == 0:
            return out
        if st.code != _SIZE:
            break
        w, h = st.args[0], st.args[1]
    raise _error(st, name)


def decode_batch(paths, height: int, width: int, n_threads: int = 4) -> np.ndarray:
    """Read and decode the PNG files ``paths``, each ``height`` x ``width``,
    into one (N, H, W, 3) uint8 RGB array in one call, on ``n_threads``
    C++ threads. Raises for the first failing file in ``paths`` order,
    naming it; a frame of another size is a ``ValueError``."""
    names = [str(p) for p in paths]
    out = np.empty((len(names), height, width, 3), np.uint8)
    if not names:
        return out
    arr = (ctypes.c_char_p * len(names))(*[os.fsencode(p) for p in names])
    st = _Status()
    rc = _lib().snn_decode_batch(arr, len(names), out.ctypes.data, height, width, n_threads,
                                 ctypes.byref(st))
    if rc < 0:
        raise ValueError(f"bad decode_batch arguments: {len(names)} paths of {width}x{height}")
    if rc > 0:
        raise _error(st, names[st.index], batch=f"{width}x{height}")
    return out


def unfilter(buf: np.ndarray, h: int, row_bytes: int, bpp: int, name: str = "<buffer>") -> None:
    """Undo the row filters of ``buf`` in place: ``h`` rows of a filter-type
    byte followed by ``row_bytes`` filtered bytes, ``bpp`` bytes a pixel.
    Raises ``ValueError`` (naming ``name``) on an unknown filter type."""
    if buf.dtype != np.uint8 or not buf.flags.c_contiguous or not buf.flags.writeable:
        raise ValueError("unfilter needs a writable C-contiguous uint8 buffer")
    if buf.size != h * (row_bytes + 1):
        raise ValueError(f"{name}: {buf.size} bytes for {h} rows of {row_bytes} + 1")
    rc = _lib().snn_png_unfilter(buf.ctypes.data, h, row_bytes, bpp)
    if rc < 0:
        raise ValueError(f"{name}: bad unfilter arguments (h={h}, row_bytes={row_bytes}, bpp={bpp})")
    if rc > 0:
        raise ValueError(f"{name}: row {rc - 1} has unknown PNG filter type {buf[(rc - 1) * (row_bytes + 1)]}")
