"""PNG reading and writing without OpenCV: the port's one decoder.

The JAX package decodes frames with ``cv2.imread`` (and optionally a C++
loader linked against libpng) and writes its synthetic frames with
``cv2.imwrite``. The machine the port runs on need not have either, so the
port reads and writes PNG itself:

- :func:`decode_png` (and :func:`read_rgb`, for a file) decodes in
  compiled host code (``csrc/png_decode.cpp`` through :mod:`.native`):
  the chunks (CRC checked), zlib's inflate of the concatenated IDAT
  stream, the five row filters and the conversion to RGB with
  ``cv2.IMREAD_COLOR`` semantics: gray is replicated, alpha is dropped, a
  palette is looked up. It takes 8-bit non-interlaced gray, gray+alpha,
  RGB, RGBA and palette images and raises ``ValueError`` naming the file
  (or the ``name`` given with the bytes) on anything else (16-bit,
  interlaced, corrupt or of the wrong size). The data loader's
  whole-batch path (:func:`.native.decode_batch`) is the same decoder.
- :func:`write_rgb` writes 8-bit RGB with one filter type for every row
  (Sub by default, as ``cv2.imwrite`` writes these frames) and ``zlib``.
- :func:`decode_png_reference` is the plain version of the decoder (the
  chunk walk in Python, the standard library's ``zlib``, the numpy row
  filters of :func:`unfilter_reference`), which the compiled one is held
  to byte for byte, errors included. Nothing on the main path calls it.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from . import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel (8-bit): gray, RGB, palette, gray+alpha, RGBA
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
FILTER_NONE, FILTER_SUB, FILTER_UP, FILTER_AVERAGE, FILTER_PAETH = range(5)


def _chunks(data: bytes, name: str):
    """Yield (type, payload memoryview) up to and including IEND."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    view, pos = memoryview(data), 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        ctype = bytes(view[pos + 4 : pos + 8])
        end = pos + 12 + length
        if end > len(data):
            raise ValueError(f"{name}: truncated {ctype.decode(errors='replace')} chunk")
        payload = view[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(payload, zlib.crc32(ctype)) != crc:
            raise ValueError(f"{name}: CRC mismatch in {ctype.decode(errors='replace')} chunk")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos = end
    raise ValueError(f"{name}: no IEND chunk")


def _ihdr(payload, name: str) -> tuple[int, int, int, int, int]:
    """(width, height, bit depth, colour type, interlace), checked."""
    if len(payload) != 13:
        raise ValueError(f"{name}: bad IHDR")
    w, h, depth, ctype, compression, filter_method, interlace = struct.unpack(">IIBBBBB", payload)
    if depth != 8:
        raise ValueError(f"{name}: {depth}-bit PNG is not supported (8-bit only)")
    if interlace != 0:
        raise ValueError(f"{name}: interlaced PNG is not supported")
    if ctype not in CHANNELS or compression != 0 or filter_method != 0 or w == 0 or h == 0:
        raise ValueError(f"{name}: unsupported PNG (colour type {ctype}, {w}x{h})")
    return w, h, depth, ctype, interlace


def png_shape(path: str | Path) -> tuple[int, int]:
    """(height, width) from the IHDR chunk alone."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def read_rgb(path: str | Path) -> np.ndarray:
    """Decode a PNG file into an (H, W, 3) uint8 RGB array."""
    return decode_png(Path(path).read_bytes(), str(path))


def decode_png(data: bytes, name: str = "PNG data") -> np.ndarray:
    """Decode PNG bytes into an (H, W, 3) uint8 RGB array: the pixels of
    ``cv2.imdecode(data, cv2.IMREAD_COLOR)`` in RGB order. ``name`` labels
    the errors."""
    return native.decode(data, name)


def decode_png_reference(data: bytes, name: str = "PNG data") -> np.ndarray:
    """The plain version of :func:`decode_png`: the same pixels and the
    same errors, in Python, ``zlib`` and numpy."""
    header, palette, idat = None, None, []
    for ctype, payload in _chunks(data, name):
        if ctype == b"IHDR":
            header = _ihdr(payload, name)
        elif ctype == b"PLTE":
            if len(payload) % 3:
                raise ValueError(f"{name}: PLTE chunk of {len(payload)} bytes is not a multiple of 3")
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None or not idat:
        raise ValueError(f"{name}: no IHDR or no IDAT chunk")
    w, h, _, ctype, _ = header
    ch = CHANNELS[ctype]
    if ctype == 3 and palette is None:
        raise ValueError(f"{name}: palette image without a PLTE chunk")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt image data ({e})") from None
    row_bytes = w * ch
    if len(raw) != h * (row_bytes + 1):
        raise ValueError(f"{name}: image data is {len(raw)} bytes, {h * (row_bytes + 1)} expected "
                         f"for {w}x{h} with {ch} samples a pixel")
    try:
        px = unfilter_reference(raw, h, row_bytes, ch).reshape(h, w, ch)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if ch == 3:
        return np.ascontiguousarray(px)
    if ch == 4:
        return np.ascontiguousarray(px[..., :3])
    if ctype == 3:
        # Indices past the palette read black, as libpng's zero-filled
        # 256-entry palette gives them.
        full = np.zeros((256, 3), np.uint8)
        full[: min(len(palette), 256)] = palette[:256]
        return full[px[..., 0]]
    return np.repeat(px[..., :1], 3, axis=2)  # gray (+ alpha dropped)


def filter_rows(pixels: np.ndarray, filter_type: int, bpp: int) -> np.ndarray:
    """Filter every row of ``pixels`` (H, row_bytes) uint8 with one filter
    type; returns (H, 1 + row_bytes) with the type byte first. Every
    predictor reads only unfiltered bytes, so this is vectorised."""
    x = pixels.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    if filter_type == FILTER_NONE:
        pred = np.zeros_like(x)
    elif filter_type == FILTER_SUB:
        pred = a
    elif filter_type == FILTER_UP:
        pred = b
    elif filter_type == FILTER_AVERAGE:
        pred = (a + b) >> 1
    elif filter_type == FILTER_PAETH:
        c = np.zeros_like(x)
        c[1:, bpp:] = x[:-1, :-bpp]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"unknown PNG filter type {filter_type}")
    out = np.empty((x.shape[0], x.shape[1] + 1), np.uint8)
    out[:, 0] = filter_type
    out[:, 1:] = (x - pred) & 0xFF
    return out


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(payload, zlib.crc32(ctype))))


def write_rgb(path: str | Path, img: np.ndarray, filter_type: int = FILTER_SUB) -> None:
    """Write an (H, W, 3) uint8 RGB array as an 8-bit RGB PNG, every row
    with ``filter_type``, compressed at zlib's fastest level (the pixels,
    not the file size, are what the tests and the loader compare)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3 or 0 in img.shape:
        raise ValueError(f"write_rgb takes an (H, W, 3) uint8 array, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = filter_rows(img.reshape(h, w * 3), filter_type, 3)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    Path(path).write_bytes(SIGNATURE + _chunk(b"IHDR", ihdr)
                           + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                           + _chunk(b"IEND", b""))


def unfilter_reference(raw, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Plain numpy version of the row filters: ``raw`` is ``h`` rows of a
    type byte and ``row_bytes`` filtered bytes; returns the reconstructed
    (h, row_bytes) uint8. None, Sub and Up are vectorised; Average and
    Paeth, which depend on the byte just reconstructed, loop over bytes."""
    rows = np.frombuffer(bytes(raw), np.uint8).reshape(h, row_bytes + 1)
    out = np.zeros((h, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    for y in range(h):
        ft, cur = int(rows[y, 0]), rows[y, 1:].copy()
        if ft == FILTER_SUB:
            pad = -row_bytes % bpp
            lanes = np.concatenate([cur, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = lanes.cumsum(axis=0, dtype=np.uint8).reshape(-1)[:row_bytes]
        elif ft == FILTER_UP:
            cur = cur + prev
        elif ft in (FILTER_AVERAGE, FILTER_PAETH):
            line, up = cur.tolist(), prev.tolist()
            for i in range(row_bytes):
                a = line[i - bpp] if i >= bpp else 0
                b = up[i]
                if ft == FILTER_AVERAGE:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                line[i] = (line[i] + pred) & 0xFF
            cur = np.array(line, np.uint8)
        elif ft != FILTER_NONE:
            raise ValueError(f"row {y} has unknown PNG filter type {ft}")
        out[y] = cur
        prev = cur
    return out
