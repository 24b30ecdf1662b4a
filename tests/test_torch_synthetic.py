"""The port's synthetic DSEC writer (data/synthetic.py) against the JAX
package's generator: same seeds, same tree. The frames are PNG files
written by different encoders (the port's, cv2's), so they are compared
after decoding, pixel for pixel; ``timestamps.txt`` is compared byte for
byte and ``tracks.npy`` field for field. Everything is exact.
"""

import cv2
import numpy as np
import pytest

from snn_object_detectionddp_tpu import config as jconfig
from snn_object_detectionddp_tpu.data import dsec as jdsec
from snn_object_detectionddp_tpu.data import synthetic as jsyn
from snn_object_detectionddp_tpu_torch import config as tconfig
from snn_object_detectionddp_tpu_torch.data import dsec as tdsec
from snn_object_detectionddp_tpu_torch.data import png
from snn_object_detectionddp_tpu_torch.data import synthetic as tsyn

CASES = {
    "default": dict(num_sequences=2, num_frames=4),
    "wide": dict(num_sequences=2, num_frames=6, height=72, width=160, num_objects=4, num_classes=5),
    # Large objects leave the frame: clipped corners and skipped records.
    "clipped": dict(num_sequences=1, num_frames=8, height=40, width=48, num_objects=3,
                    obj_size=(20, 44)),
}


@pytest.fixture(scope="module", params=list(CASES))
def trees(request, tmp_path_factory):
    kw = CASES[request.param]
    root = tmp_path_factory.mktemp(request.param)
    return (jsyn.make_dataset(root / "jax", **kw), tsyn.make_dataset(root / "port", **kw), kw)


def _rel(root):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def test_same_files(trees):
    jroot, troot, kw = trees
    assert _rel(troot) == _rel(jroot)
    n_png = sum(1 for p in _rel(troot) if p.suffix == ".png")
    assert n_png == 2 * kw["num_sequences"] * kw["num_frames"]  # train + test splits


def test_frames_decode_to_the_jax_pixels(trees):
    jroot, troot, _ = trees
    for rel in _rel(jroot):
        if rel.suffix == ".png":
            want = cv2.imread(str(jroot / rel))[..., ::-1]
            np.testing.assert_array_equal(png.read_rgb(troot / rel), want)
            np.testing.assert_array_equal(cv2.imread(str(troot / rel))[..., ::-1], want)


def test_timestamps_are_byte_equal(trees):
    jroot, troot, _ = trees
    for rel in _rel(jroot):
        if rel.name == "timestamps.txt":
            assert (troot / rel).read_bytes() == (jroot / rel).read_bytes()


def test_tracks_are_equal(trees):
    jroot, troot, _ = trees
    n = 0
    for rel in _rel(jroot):
        if rel.name == "tracks.npy":
            got, want = np.load(troot / rel), np.load(jroot / rel)
            assert got.dtype == want.dtype == tsyn.TRACKS_DTYPE == jsyn.TRACKS_DTYPE
            assert got.tobytes() == want.tobytes()
            n += len(got)
    assert n > 0


def test_the_index_reads_the_same_labels(trees):
    jroot, troot, kw = trees
    jcfg, tcfg = jconfig.Config(), tconfig.Config()
    jcfg.dataset.train.path, tcfg.dataset.train.path = str(jroot / "train"), str(troot / "train")
    jcfg.dataset.train.seq_len = tcfg.dataset.train.seq_len = 2
    j, t = jdsec.DSECIndex(jcfg, "train"), tdsec.DSECIndex(tcfg, "train")
    assert len(t) == len(j) == kw["num_sequences"] * (kw["num_frames"] - 1)
    h, w = kw.get("height", 96), kw.get("width", 128)
    for i in range(len(t)):
        np.testing.assert_array_equal(t.sample_labels(i, h, w), j.sample_labels(i, h, w))
