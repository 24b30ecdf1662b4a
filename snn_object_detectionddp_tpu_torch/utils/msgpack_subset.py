"""A decoder for the msgpack that flax checkpoints are written in.

The port reads the JAX package's checkpoints (``fixtures/hard_nano_ckpt.pt``,
a JAX ``best.pt``) on a machine that need not have the ``msgpack`` package.
``flax.serialization.msgpack_serialize`` writes nested maps of str keys to
ints, floats, None, booleans, str, bytes and arrays, with numpy arrays and
numpy scalars as extension types (code 1 and code 3: a packed
``[shape, dtype name, raw bytes]``). :func:`unpackb` decodes every msgpack
format that can carry those values: nil, false, true, the ints (fixint,
uint8-64, int8-64), float32/64, str, bin, arrays, maps and the ext formats,
and gives each ext to ``ext_hook(code, payload)`` as ``msgpack.unpackb``
does. It returns what ``msgpack.unpackb(data, ext_hook=..., raw=raw,
strict_map_key=False)`` returns: lists for arrays, dicts for maps.

Anything else raises ``ValueError`` naming the byte offset: the reserved
byte 0xc1, a truncated object, invalid UTF-8 in a str (unless ``raw``), a
map key that cannot be a dict key, an ext with no hook, trailing bytes,
and nesting deeper than ``MAX_DEPTH``.
"""

from __future__ import annotations

import struct

MAX_DEPTH = 256
_FIXED = {  # format byte -> (struct format, size) of fixed-width scalars
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}
# str8/16/32, bin8/16/32, array16/32, map16/32, ext8/16/32: width of the length
_STR, _BIN = {0xD9: 1, 0xDA: 2, 0xDB: 4}, {0xC4: 1, 0xC5: 2, 0xC6: 4}
_ARRAY, _MAP = {0xDC: 2, 0xDD: 4}, {0xDE: 2, 0xDF: 4}
_EXT = {0xC7: 1, 0xC8: 2, 0xC9: 4}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes, ext_hook, raw: bool):
        self.data, self.pos, self.ext_hook, self.raw = memoryview(data), 0, ext_hook, raw

    def take(self, n: int, start: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"msgpack: object at byte {start} runs past the end of the data "
                             f"({len(self.data)} bytes)")
        view = self.data[self.pos:end]
        self.pos = end
        return view

    def length(self, width: int, start: int) -> int:
        return struct.unpack(_LEN[width], self.take(width, start))[0]

    def text(self, n: int, start: int):
        buf = bytes(self.take(n, start))
        if self.raw:
            return buf
        try:
            return buf.decode("utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"msgpack: invalid UTF-8 in the str at byte {start}") from e

    def ext(self, code: int, n: int, start: int):
        payload = bytes(self.take(n, start))
        if self.ext_hook is None:
            raise ValueError(f"msgpack: extension type {code} at byte {start} and no ext_hook")
        return self.ext_hook(code, payload)

    def value(self, depth: int = 0):
        if depth > MAX_DEPTH:
            raise ValueError(f"msgpack: nesting deeper than {MAX_DEPTH} at byte {self.pos}")
        start = self.pos
        b = self.take(1, start)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, depth, start)
        if 0x90 <= b <= 0x9F:
            return [self.value(depth + 1) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F, start)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            fmt, size = _FIXED[b]
            return struct.unpack(fmt, self.take(size, start))[0]
        if b in _STR:
            return self.text(self.length(_STR[b], start), start)
        if b in _BIN:
            return bytes(self.take(self.length(_BIN[b], start), start))
        if b in _ARRAY:
            return [self.value(depth + 1) for _ in range(self.length(_ARRAY[b], start))]
        if b in _MAP:
            return self.map(self.length(_MAP[b], start), depth, start)
        if b in _EXT:
            n = self.length(_EXT[b], start)
            code = struct.unpack(">b", self.take(1, start))[0]
            return self.ext(code, n, start)
        if b in _FIXEXT:
            code = struct.unpack(">b", self.take(1, start))[0]
            return self.ext(code, _FIXEXT[b], start)
        raise ValueError(f"msgpack: format byte 0x{b:02x} at byte {start} is not valid msgpack")

    def map(self, n: int, depth: int, start: int) -> dict:
        out = {}
        for _ in range(n):
            key_at = self.pos
            key = self.value(depth + 1)
            try:
                hash(key)
            except TypeError as e:
                raise ValueError(f"msgpack: the map key at byte {key_at} ({type(key).__name__}) "
                                 "cannot be a dict key") from e
            out[key] = self.value(depth + 1)
        return out


def unpackb(data: bytes, ext_hook=None, raw: bool = False):
    """Decode one msgpack object that fills ``data`` exactly."""
    reader = _Reader(bytes(data), ext_hook, raw)
    value = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} trailing bytes after the "
                         f"object, from byte {reader.pos}")
    return value
