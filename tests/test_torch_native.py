"""The port's C++ PNG decoder (csrc/png_decode.cpp through data/native.py)
against its plain version and against the JAX package.

- ``decode_png`` (the compiled decoder) equals ``decode_png_reference``
  (the chunk walk in Python, ``zlib``, the numpy row filters) byte for
  byte on seeded images of every colour type, every filter type and mixed
  filters, IDAT split over several chunks, and stored, fixed-Huffman and
  dynamic-Huffman zlib streams; every error raises the same type and words.
- ``decode_batch`` equals the JAX loader's decode (``cv2.imread``, RGB) on
  the JAX package's synthetic tree, at any thread count, and names the
  file it failed on.
- ``BatchLoader``, which decodes each batch in one ``decode_batch`` call,
  gives the bytes of the plain version's batches and of the JAX package's
  ``BatchLoader``; a failed decode or build raises from it, with no
  fallback.

The JAX package's own ``native.decode_batch`` is not called here: it
builds its library into the JAX package's directory on first use.
"""

import zlib

import numpy as np
import pytest
from test_torch_png import _bad_files

from snn_object_detectionddp_tpu import config as jconfig
from snn_object_detectionddp_tpu.data import dsec as jdsec
from snn_object_detectionddp_tpu.data import pipeline as jpipe
from snn_object_detectionddp_tpu.data.synthetic import make_dataset
from snn_object_detectionddp_tpu_torch import config as tconfig
from snn_object_detectionddp_tpu_torch.data import dsec as tdsec
from snn_object_detectionddp_tpu_torch.data import native, png
from snn_object_detectionddp_tpu_torch.data import pipeline as tpipe
from snn_object_detectionddp_tpu_torch.kernels import build

# kind -> (PNG colour type, samples a pixel)
KINDS = {"gray": (0, 1), "gray_alpha": (4, 2), "rgb": (2, 3), "rgba": (6, 4), "palette": (3, 1)}
# zlib setting -> the deflate block type it opens with (0 stored, 1 fixed, 2 dynamic)
STREAMS = {"level0": (0, 0), "fixed": (6, 1), "level1": (1, 2), "level6": (6, 2), "level9": (9, 2)}
BAD = ["missing", "sixteen_bit", "interlaced", "wrong_size", "bad_crc", "bad_filter", "not_png",
       "truncated"]


def _compress(raw: bytes, stream: str) -> bytes:
    level, _ = STREAMS[stream]
    strategy = zlib.Z_FIXED if stream == "fixed" else zlib.Z_DEFAULT_STRATEGY
    co = zlib.compressobj(level, zlib.DEFLATED, 15, 8, strategy)
    return co.compress(raw) + co.flush()


def _encode(px, filters, colour_type, palette=None, stream="level6", parts=1) -> bytes:
    """An 8-bit PNG of ``px`` (H, W, C), row y filtered with ``filters[y]``
    and the zlib stream cut into ``parts`` IDAT chunks."""
    h, w, c = px.shape
    flat = px.reshape(h, w * c)
    by_type = np.stack([png.filter_rows(flat, ft, c) for ft in range(5)])
    idat = _compress(by_type[np.asarray(filters), np.arange(h)].tobytes(), stream)
    cut = np.linspace(0, len(idat), parts + 1).astype(int)
    ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, colour_type, 0, 0, 0])
    data = png.SIGNATURE + png._chunk(b"IHDR", ihdr)
    if palette is not None:
        data += png._chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    for a, b in zip(cut, cut[1:]):
        data += png._chunk(b"IDAT", idat[a:b])
    return data + png._chunk(b"IEND", b"")


def _image(rng, kind, h=24, w=40):
    """Ramps with a little noise (so zlib finds matches: the streams are
    the block types STREAMS names) and a noisy band; a palette image
    indexes past its 20-entry palette."""
    c = KINDS[kind][1]
    y, x, ch = np.meshgrid(np.arange(h), np.arange(w), np.arange(c), indexing="ij")
    if kind == "palette":
        px = (x // 4 + y // 5 + rng.randint(0, 2, (h, w, c))) % 24
        px[h // 3 : h // 3 + 3] = rng.randint(0, 24, (3, w, c))
        return px.astype(np.uint8), rng.randint(0, 256, (20, 3))
    px = (3 * x + 2 * y + 40 * ch + rng.randint(0, 3, (h, w, c))) % 256
    px[h // 3 : h // 3 + 3] = rng.randint(0, 256, (3, w, c))
    px[-4:] = rng.randint(0, 4, (4, w, c)) * 40  # few levels: Paeth's ties
    return px.astype(np.uint8), None


def _expected_rgb(px, kind, palette):
    if kind == "palette":
        table = np.zeros((256, 3), np.uint8)
        table[: len(palette)] = palette
        return table[px[..., 0]]
    return px[..., :3] if px.shape[2] >= 3 else np.repeat(px[..., :1], 3, axis=2)


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("kind", KINDS)
def test_decoder_equals_the_reference(kind, stream):
    rng = np.random.RandomState(len(kind) * 10 + len(stream))
    px, palette = _image(rng, kind)
    h = px.shape[0]
    plans = [[ft] * h for ft in range(5)] + [rng.randint(0, 5, h).tolist()]
    for filters in plans:
        for parts in (1, 3):
            data = _encode(px, filters, KINDS[kind][0], palette, stream, parts)
            idat = b"".join(bytes(p) for t, p in png._chunks(data, "img") if t == b"IDAT")
            assert (idat[2] >> 1) & 3 == STREAMS[stream][1]  # the first deflate block's type
            want = png.decode_png_reference(data, "img")
            got = png.decode_png(data, "img")
            assert got.dtype == np.uint8 and got.shape == want.shape and got.flags.c_contiguous
            assert got.tobytes() == want.tobytes(), (filters, parts)
            np.testing.assert_array_equal(got, _expected_rgb(px, kind, palette))


@pytest.mark.parametrize("case", [c for c in BAD if c != "missing"])
def test_errors_equal_the_reference(tmp_path, case):
    """decode_png and decode_png_reference raise the same type and words."""
    what, exc, match = _bad_files(tmp_path)[case]
    if not isinstance(what, bytes):
        what = what.read_bytes()
    with pytest.raises(exc, match=match) as got:
        png.decode_png(what, f"{case}.png")
    with pytest.raises(exc) as want:
        png.decode_png_reference(what, f"{case}.png")
    assert str(got.value) == str(want.value)


def test_corrupt_streams_equal_the_reference():
    """zlib's own failures (bad header, bad data, an early end, trailing
    bytes after the stream's end) and palette faults, worded as the
    reference words them."""
    rng = np.random.RandomState(3)
    px, _ = _image(rng, "rgb")
    rows = png.filter_rows(px.reshape(24, 120), 1, 3).tobytes()
    idat = zlib.compress(rows, 6)
    assert (idat[2] >> 1) & 3 == 2  # dynamic Huffman

    def png_of(stream, ctype=2, plte=None):
        data = png.SIGNATURE + png._chunk(b"IHDR", (40).to_bytes(4, "big") + (24).to_bytes(4, "big")
                                           + bytes([8, ctype, 0, 0, 0]))
        if plte is not None:
            data += png._chunk(b"PLTE", plte)
        return data + png._chunk(b"IDAT", stream) + png._chunk(b"IEND", b"")

    bad_data = bytearray(idat)
    bad_data[len(idat) // 2] ^= 0xFF
    cases = [b"\x00\x01" + idat[2:], bytes(bad_data), idat[:-9], zlib.compress(rows[:-5]),
             zlib.compress(rows + b"\x01" * 4), zlib.compress(rows + bytes(200_000))]
    for stream in cases:
        with pytest.raises(ValueError) as want:
            png.decode_png_reference(png_of(stream), "z")
        with pytest.raises(ValueError) as got:
            png.decode_png(png_of(stream), "z")
        assert str(got.value) == str(want.value)
    trailing = png_of(idat + b"trailing bytes")
    np.testing.assert_array_equal(png.decode_png(trailing), png.decode_png_reference(trailing))
    for plte in (None, bytes(7)):
        with pytest.raises(ValueError) as want:
            png.decode_png_reference(png_of(idat, 3, plte), "p")
        with pytest.raises(ValueError, match="^p: ") as got:
            png.decode_png(png_of(idat, 3, plte), "p")
        assert str(got.value) == str(want.value)


def _frames(root, n, hw=(8, 10), seed=0):
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        paths.append(root / f"f{i}.png")
        png.write_rgb(paths[-1], rng.randint(0, 256, (*hw, 3), dtype=np.uint8), i % 5)
    return paths


@pytest.mark.parametrize("at", [0, 2])
@pytest.mark.parametrize("case", BAD)
def test_decode_batch_names_the_failing_file(tmp_path, case, at):
    what, exc, match = _bad_files(tmp_path)[case]
    paths = _frames(tmp_path, 4)
    if isinstance(what, bytes):
        paths[at].write_bytes(what)
    else:
        paths[at] = what
    with pytest.raises(exc, match=match) as got:
        native.decode_batch(paths, 8, 10, n_threads=1 if at == 0 else 3)
    assert paths[at].name in str(got.value)
    with pytest.raises(exc) as want:
        png.read_rgb(paths[at])
    assert str(got.value) == str(want.value)


def test_decode_batch_reports_the_lowest_failing_index(tmp_path):
    """Frame 2 has a bad filter type in its last row, so it fails only
    after a whole 480x640 frame is inflated; frame 9 is missing and fails
    at once. With a thread per frame, frame 2 is still the one reported."""
    zeros = np.zeros((480, 640, 3), np.uint8)
    paths = [tmp_path / f"z{i}.png" for i in range(12)]
    for p in paths:
        png.write_rgb(p, zeros)
    px, _ = _image(np.random.RandomState(0), "rgb", 480, 640)
    rows = png.filter_rows(px.reshape(480, -1), 1, 3)
    rows[-1, 0] = 9
    ihdr = (640).to_bytes(4, "big") + (480).to_bytes(4, "big") + bytes([8, 2, 0, 0, 0])
    paths[2].write_bytes(png.SIGNATURE + png._chunk(b"IHDR", ihdr)
                         + png._chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                         + png._chunk(b"IEND", b""))
    paths[9] = tmp_path / "missing.png"
    for n_threads in (1, 12, 12, 12):
        with pytest.raises(ValueError, match="z2.png: row 479 has unknown PNG filter type 9"):
            native.decode_batch(paths, 480, 640, n_threads)
    with pytest.raises(FileNotFoundError, match="missing.png"):
        native.decode_batch(paths[3:], 480, 640, 12)


def test_frame_of_another_size_raises(tmp_path):
    paths = _frames(tmp_path, 3)
    png.write_rgb(paths[1], np.zeros((9, 10, 3), np.uint8))
    with pytest.raises(ValueError, match="f1.png: frame is 10x9, the batch is 10x8"):
        native.decode_batch(paths, 8, 10)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("dsec")
    make_dataset(root, num_sequences=2, num_frames=6, height=48, width=64)
    return root


def test_decode_batch_equals_cv2_at_every_thread_count(tree):
    """The JAX loader's default decode (cv2.imread, BGR to RGB) of every
    frame of the JAX synthetic tree; the lowest failing index is reported
    whatever the threads finish first."""
    paths = sorted(tree.rglob("*.png"))
    want = np.stack([jpipe._decode_frame(str(p)) for p in paths])
    for n_threads in (-3, 0, 1, 3, len(paths) + 5):  # fewer than 1 runs on one
        got = native.decode_batch(paths, 48, 64, n_threads)
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), n_threads
    assert native.decode_batch([], 48, 64).shape == (0, 48, 64, 3)
    broken = list(paths)
    broken[3], broken[9] = tree / "missing_3.png", tree / "missing_9.png"
    for n_threads in (1, 4, 16):
        with pytest.raises(FileNotFoundError, match="missing_3.png"):
            native.decode_batch(broken, 48, 64, n_threads)


def _cfgs(root, seq_len=3):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.Config()
        for split in ("train", "val", "test"):
            cfg.dataset.split(split).path = str(root / ("test" if split == "test" else "train"))
            cfg.dataset.split(split).seq_len = seq_len
        cfg.model.max_boxes = 8
        out.append(cfg)
    return out


def _epochs(mods, cfg, mode, kw):
    index = mods[0].DSECIndex(cfg, mode)
    kw = dict(kw)
    loader = mods[1].BatchLoader(index, kw.pop("indices", list(range(len(index)))), **kw)
    return [list(loader) for _ in range(2)]


def _reference_decode(self, samples):
    """BatchLoader._decode's plain version: decode_png_reference of each
    frame, then ``transform``."""
    fn = self.transform or (lambda f: f)
    return np.stack([np.stack([fn(png.decode_png_reference(open(p, "rb").read(), p))
                               for p in s.frame_paths]) for s in samples])


@pytest.mark.parametrize(
    "mode,kw",
    [
        ("train", dict(batch_size=3, shuffle=True, seed=5)),
        ("val", dict(batch_size=3, indices=[5, 0, 7, 2])),
        ("train", dict(batch_size=2, transform=lambda f: 255 - f)),
        ("test", dict(batch_size=4)),
    ],
    ids=["shuffled", "partial", "transform", "test_mode"],
)
def test_batches_equal_the_reference_and_jax(tree, monkeypatch, mode, kw):
    jcfg, tcfg = _cfgs(tree)
    opts = {"max_boxes": 8, "num_threads": 2, **kw}
    monkeypatch.delenv("SNN_TPU_NATIVE_DECODE", raising=False)
    want = _epochs((jdsec, jpipe), jcfg, mode, opts)  # cv2 threads
    calls = []
    real = native.decode_batch

    def counted(paths, *a, **k):
        calls.append(len(paths))
        return real(paths, *a, **k)

    monkeypatch.setattr(native, "decode_batch", counted)
    got = _epochs((tdsec, tpipe), tcfg, mode, opts)
    rows = [int(b["sample_mask"].sum()) * 3 for epoch in got for b in epoch]
    assert calls == rows  # one call a batch, all B*T real frames in it
    monkeypatch.setattr(tpipe.BatchLoader, "_decode", _reference_decode)
    plain = _epochs((tdsec, tpipe), tcfg, mode, opts)
    assert len(calls) == len(rows)  # the plain version made no decode_batch call
    for other in (plain, want):
        assert [len(e) for e in got] == [len(e) for e in other]
        for bg, bo in zip(sum(got, []), sum(other, [])):
            assert set(bg) == set(bo) and bg["paths"] == bo["paths"]
            for k in set(bo) - {"paths"}:
                assert bg[k].dtype == bo[k].dtype and bg[k].shape == bo[k].shape, k
                assert bg[k].tobytes() == bo[k].tobytes(), k


def test_the_plain_version_is_off_the_main_path(tree, monkeypatch):
    """read_rgb and the loader decode with the plain version's chunk walk,
    zlib and row filters all made to raise."""
    def refuse(*a, **k):
        raise AssertionError("the plain version was called")

    for name in ("decode_png_reference", "unfilter_reference", "_chunks"):
        monkeypatch.setattr(png, name, refuse)
    monkeypatch.setattr(png.zlib, "decompress", refuse)
    path = sorted(tree.rglob("*.png"))[0]
    np.testing.assert_array_equal(png.read_rgb(path), jpipe._decode_frame(str(path)))
    _, tcfg = _cfgs(tree)
    assert len(_epochs((tdsec, tpipe), tcfg, "train", {"batch_size": 4})[0]) == 2


@pytest.mark.parametrize("flag", ["0", "1"])
def test_a_failed_decode_or_build_raises_from_the_loader(tree, tmp_path, monkeypatch, flag):
    """Whatever the JAX package's opt-in SNN_TPU_NATIVE_DECODE says: the
    port has one decode path and no fallback."""
    import shutil

    monkeypatch.setenv("SNN_TPU_NATIVE_DECODE", flag)
    root = tmp_path / "broken"
    shutil.copytree(tree / "train" / "seq_00", root / "seq_00")
    (root / "seq_00/images/left/distorted/000004.png").write_bytes(b"not a png")
    _, cfg = _cfgs(root)
    cfg.dataset.train.path = str(root)
    index = tdsec.DSECIndex(cfg, "train")
    with pytest.raises(ValueError, match="000004.png: not a PNG file"):
        list(tpipe.BatchLoader(index, list(range(len(index))), batch_size=2, num_threads=1))

    def broken(source):
        raise RuntimeError(f"g++ failed (1): {source} did not build")

    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "build", broken)
    with pytest.raises(RuntimeError, match="png_decode.cpp did not build"):
        list(tpipe.BatchLoader(index, [0, 1], batch_size=2, num_threads=1))
