"""The port's PNG reader and writer (data/png.py, data/native.py,
csrc/png_unfilter.cpp) against OpenCV, which the JAX package decodes and
writes its frames with, and against the plain numpy row filters.

Every comparison is exact (uint8 pixels): ``read_rgb`` must give
``cv2.imread(path)[..., ::-1]`` (and ``decode_png`` of the bytes
``cv2.imdecode(data, IMREAD_COLOR)[..., ::-1]``) (IMREAD_COLOR: gray replicated, alpha
dropped, palette looked up) on every kind of 8-bit PNG it accepts, and the
compiled unfilter the bytes of ``unfilter_reference``.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest

from snn_object_detectionddp_tpu.data.synthetic import make_dataset
from snn_object_detectionddp_tpu_torch.data import native, png

COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # samples a pixel -> PNG colour type


def _chunk(ctype, payload):
    return struct.pack(">I", len(payload)) + ctype + payload + struct.pack(
        ">I", zlib.crc32(ctype + payload))


def _encode(pixels, filters, color_type=None, palette=None, depth=8, interlace=0):
    """A tiny independent PNG encoder: (H, W, C) uint8 pixels, one filter
    type per row (PNG spec section 9), predictors from the raw bytes."""
    h, w, c = pixels.shape
    raw = pixels.reshape(h, w * c).astype(np.int32)
    out = []
    for y in range(h):
        x = raw[y]
        a = np.concatenate([np.zeros(c, np.int32), x[:-c]])
        b = raw[y - 1] if y else np.zeros_like(x)
        cc = np.concatenate([np.zeros(c, np.int32), b[:-c]])
        ft = int(filters[y])
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = a
        elif ft == 2:
            pred = b
        elif ft == 3:
            pred = (a + b) // 2
        else:
            p = a + b - cc
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        out.append(bytes([ft]) + ((x - pred) % 256).astype(np.uint8).tobytes())
    ctype = COLOR_TYPE[c] if color_type is None else color_type
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                               interlace))
    if palette is not None:
        data += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    idat = zlib.compress(b"".join(out), 6)
    # Two IDAT chunks: the reader must inflate their concatenation.
    data += _chunk(b"IDAT", idat[: len(idat) // 2]) + _chunk(b"IDAT", idat[len(idat) // 2 :])
    return data + _chunk(b"IEND", b"")


def _cv2_rgb(path):
    img = cv2.imread(str(path))
    assert img is not None
    return img[..., ::-1]


@pytest.mark.parametrize("kind", ["rgb", "gray", "rgba"])
@pytest.mark.parametrize("hw", [(31, 45), (64, 96)], ids=["odd", "even"])
def test_read_rgb_equals_cv2_on_cv2_files(tmp_path, kind, hw):
    rng = np.random.RandomState(hw[0])
    shape = {"rgb": (*hw, 3), "gray": hw, "rgba": (*hw, 4)}[kind]
    img = rng.randint(0, 256, shape, dtype=np.uint8)
    img[: hw[0] // 2] //= 7  # smooth and noisy regions
    path = tmp_path / f"{kind}.png"
    assert cv2.imwrite(str(path), img)
    got = png.read_rgb(path)
    assert got.dtype == np.uint8 and got.shape == (*hw, 3) and got.flags.c_contiguous
    np.testing.assert_array_equal(got, _cv2_rgb(path))
    assert png.png_shape(path) == hw


@pytest.mark.parametrize("kind", ["rgb", "gray", "rgba"])
@pytest.mark.parametrize("hw", [(31, 45), (48, 64)], ids=["odd", "even"])
def test_decode_png_equals_cv2_imdecode(kind, hw):
    """Bytes in memory (an HTTP upload): ``decode_png`` gives the pixels of
    ``cv2.imdecode(data, IMREAD_COLOR)`` in RGB order, exactly."""
    rng = np.random.RandomState(hw[1])
    shape = {"rgb": (*hw, 3), "gray": hw, "rgba": (*hw, 4)}[kind]
    img = rng.randint(0, 256, shape, dtype=np.uint8)
    img[:, : hw[1] // 3] //= 5
    ok, buf = cv2.imencode(".png", img)
    assert ok
    data = buf.tobytes()
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
    got = png.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == (*hw, 3) and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="upload: CRC"):
        corrupt = bytearray(data)
        corrupt[40] ^= 0xFF
        png.decode_png(bytes(corrupt), "upload")


@pytest.mark.parametrize("ft", range(5), ids=["none", "sub", "up", "average", "paeth"])
def test_each_filter_round_trips(tmp_path, ft):
    rng = np.random.RandomState(ft)
    for c in (1, 2, 3, 4):
        px = rng.randint(0, 256, (13, 17, c), dtype=np.uint8)
        px[5:9] = px[5:9] // 16 * 16  # repeated values exercise the predictors' ties
        path = tmp_path / f"f{ft}_c{c}.png"
        path.write_bytes(_encode(px, [ft] * 13))
        got = png.read_rgb(path)
        want = px[..., :3] if c >= 3 else np.repeat(px[..., :1], 3, axis=2)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _cv2_rgb(path))


def test_mixed_filters_and_palette_equal_cv2(tmp_path):
    rng = np.random.RandomState(7)
    px = rng.randint(0, 256, (40, 50, 3), dtype=np.uint8)
    filters = rng.randint(0, 5, 40)
    path = tmp_path / "mixed.png"
    path.write_bytes(_encode(px, filters))
    np.testing.assert_array_equal(png.read_rgb(path), px)
    np.testing.assert_array_equal(png.read_rgb(path), _cv2_rgb(path))
    # A palette image (colour type 3): indices into 20 RGB entries.
    palette = rng.randint(0, 256, (20, 3))
    idx = rng.randint(0, 20, (40, 50, 1), dtype=np.uint8)
    path = tmp_path / "palette.png"
    path.write_bytes(_encode(idx, filters, color_type=3, palette=palette))
    np.testing.assert_array_equal(png.read_rgb(path), palette.astype(np.uint8)[idx[..., 0]])
    np.testing.assert_array_equal(png.read_rgb(path), _cv2_rgb(path))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_compiled_unfilter_is_bit_equal_to_the_reference(bpp):
    """Random filtered bytes with a random filter type per row: any input
    has one reconstruction, and both versions must give it."""
    rng = np.random.RandomState(bpp)
    for h, w in ((1, 1), (9, 23), (64, 80)):
        row_bytes = w * bpp
        raw = rng.randint(0, 256, (h, row_bytes + 1)).astype(np.uint8)
        raw[:, 0] = rng.randint(0, 5, h)
        want = png.unfilter_reference(raw.tobytes(), h, row_bytes, bpp)
        buf = raw.reshape(-1).copy()
        native.unfilter(buf, h, row_bytes, bpp)
        got = buf.reshape(h, row_bytes + 1)
        np.testing.assert_array_equal(got[:, 1:], want)
        np.testing.assert_array_equal(got[:, 0], raw[:, 0])  # type bytes left alone


def test_unfilter_rejects_an_unknown_filter_type():
    raw = np.zeros((3, 7), np.uint8)
    raw[1, 0] = 5
    with pytest.raises(ValueError, match="row 1 has unknown PNG filter type 5"):
        native.unfilter(raw.reshape(-1).copy(), 3, 6, 3)
    with pytest.raises(ValueError, match="unknown PNG filter type"):
        png.unfilter_reference(raw.tobytes(), 3, 6, 3)
    with pytest.raises(ValueError, match="writable"):
        native.unfilter(np.frombuffer(raw.tobytes(), np.uint8), 3, 6, 3)


def test_read_rgb_on_the_jax_synthetic_tree(tmp_path):
    make_dataset(tmp_path, num_sequences=2, splits=("train",), num_frames=3, height=48, width=64)
    paths = sorted(tmp_path.rglob("*.png"))
    assert len(paths) == 6
    for p in paths:
        np.testing.assert_array_equal(png.read_rgb(p), _cv2_rgb(p))


@pytest.mark.parametrize("ft", range(5), ids=["none", "sub", "up", "average", "paeth"])
def test_write_rgb_is_read_back_by_cv2(tmp_path, ft):
    img = np.random.RandomState(ft).randint(0, 256, (37, 53, 3), dtype=np.uint8)
    img[10:20, 5:40] = (200, 60, 60)
    path = tmp_path / "w.png"
    png.write_rgb(path, img, ft)
    np.testing.assert_array_equal(_cv2_rgb(path), img)
    np.testing.assert_array_equal(png.read_rgb(path), img)
    # One filter type on every row.
    raw = zlib.decompress(path.read_bytes()[33 + 8 : -12 - 4])
    assert set(raw[:: 53 * 3 + 1]) == {ft}


def test_write_rgb_rejects_other_arrays(tmp_path):
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4, 4, 3), np.float32), np.zeros((0, 4, 3), np.uint8)):
        with pytest.raises(ValueError, match="uint8"):
            png.write_rgb(tmp_path / "x.png", bad)
    with pytest.raises(ValueError, match="filter type"):
        png.write_rgb(tmp_path / "x.png", np.zeros((4, 4, 3), np.uint8), 7)


def _bad_files(tmp_path):
    px = np.random.RandomState(0).randint(0, 256, (8, 10, 3), dtype=np.uint8)
    good = _encode(px, [1] * 8)
    sixteen = tmp_path / "16bit.png"
    assert cv2.imwrite(str(sixteen), (px.astype(np.uint16) * 257))
    short = bytearray(_encode(px[:7], [1] * 7))
    short[16:24] = struct.pack(">II", 10, 8)  # IHDR says 8 rows, IDAT holds 7
    short[29:33] = struct.pack(">I", zlib.crc32(bytes(short[12:29])))
    crc = bytearray(good)
    crc[45] ^= 0xFF
    return {
        "missing": (tmp_path / "nope.png", FileNotFoundError, "nope.png"),
        "sixteen_bit": (sixteen, ValueError, "16-bit"),
        "interlaced": (_encode(px, [1] * 8, interlace=1), ValueError, "interlaced"),
        "wrong_size": (bytes(short), ValueError, "expected"),
        "bad_crc": (bytes(crc), ValueError, "CRC"),
        "bad_filter": (_encode(px, [1, 1, 1, 9, 1, 1, 1, 1]), ValueError, "row 3"),
        "not_png": (b"GIF89a" + bytes(40), ValueError, "not a PNG"),
        "truncated": (good[:-20], ValueError, "truncated|IEND"),
    }


@pytest.mark.parametrize("case", ["missing", "sixteen_bit", "interlaced", "wrong_size", "bad_crc",
                                  "bad_filter", "not_png", "truncated"])
def test_read_rgb_raises_naming_the_file(tmp_path, case):
    what, exc, match = _bad_files(tmp_path)[case]
    path = tmp_path / f"{case}.png"
    if isinstance(what, bytes):
        path.write_bytes(what)
    else:
        path = what
    with pytest.raises(exc, match=match) as info:
        png.read_rgb(path)
    assert path.name in str(info.value)


def test_png_shape_reads_the_header_only(tmp_path):
    path = tmp_path / "s.png"
    png.write_rgb(path, np.zeros((21, 34, 3), np.uint8))
    head = path.read_bytes()[:33]
    (tmp_path / "head.png").write_bytes(head)  # no IDAT at all
    assert png.png_shape(tmp_path / "head.png") == (21, 34)
    with pytest.raises(FileNotFoundError):
        png.png_shape(tmp_path / "missing.png")
    with pytest.raises(ValueError, match="not a PNG"):
        (tmp_path / "t.txt").write_bytes(b"hello" * 10)
        png.png_shape(tmp_path / "t.txt")
