"""The port's synthetic DSEC writer (data/synthetic.py) against the JAX
package's generator: same seeds, same tree. The frames are PNG files
written by different encoders (the port's, cv2's), so they are compared
after decoding, pixel for pixel; ``timestamps.txt`` is compared byte for
byte and ``tracks.npy`` field for field. Everything is exact.

The hard profile (``make_sequence_hard``) is held the same way on the
whole nano fixture tree and on flagship ``train/seq_00`` (480x640, 24
frames), both against the JAX generator, and both trees must give the
digests pinned in data/fixtures.py.
"""

import sys
from pathlib import Path


import cv2
import numpy as np
import pytest

from snn_object_detectionddp_tpu import config as jconfig
from snn_object_detectionddp_tpu.data import dsec as jdsec
from snn_object_detectionddp_tpu.data import synthetic as jsyn
from snn_object_detectionddp_tpu_torch import config as tconfig
from snn_object_detectionddp_tpu_torch.data import dsec as tdsec
from snn_object_detectionddp_tpu_torch.data import fixtures
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


REPO = Path(__file__).resolve().parents[1]


def _jax_hard_fixture():
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import make_hard_fixture
    finally:
        sys.path.remove(str(REPO / "scripts"))
    return make_hard_fixture


@pytest.fixture(scope="module", params=["nano", "flagship_seq00"])
def hard_trees(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(request.param)
    if request.param == "nano":
        jroot = _jax_hard_fixture().make_hard_nano(root / "jax")
        troot = fixtures.make_hard_nano(root / "port")
        pinned = fixtures.NANO_DIGEST
    else:
        seed = fixtures.FLAGSHIP_SEEDS["train"][0]
        jsyn.make_sequence_hard(root / "jax", seed=seed, **fixtures.FLAGSHIP)
        tsyn.make_sequence_hard(root / "port", seed=seed, **fixtures.FLAGSHIP)
        jroot, troot, pinned = root / "jax", root / "port", fixtures.FLAGSHIP_SEQ00_DIGEST
    return jroot, troot, pinned


def test_hard_same_files(hard_trees):
    jroot, troot, _ = hard_trees
    assert _rel(troot) == _rel(jroot)
    assert sum(1 for p in _rel(troot) if p.suffix == ".png") in (86 * 16, 24)


def test_hard_frames_decode_to_the_jax_pixels(hard_trees):
    jroot, troot, _ = hard_trees
    for rel in _rel(jroot):
        if rel.suffix == ".png":
            np.testing.assert_array_equal(png.read_rgb(troot / rel), cv2.imread(str(jroot / rel))[..., ::-1])


def test_hard_timestamps_and_tracks_are_equal(hard_trees):
    jroot, troot, _ = hard_trees
    n = 0
    for rel in _rel(jroot):
        if rel.name == "timestamps.txt":
            assert (troot / rel).read_bytes() == (jroot / rel).read_bytes()
        if rel.name == "tracks.npy":
            got, want = np.load(troot / rel), np.load(jroot / rel)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
            n += len(got)
    assert n > 0


def test_hard_trees_give_the_pinned_digest(hard_trees):
    jroot, troot, pinned = hard_trees
    assert fixtures.tree_digest(troot) == fixtures.tree_digest(jroot) == pinned


def test_hard_nano_parameters_are_the_jax_scripts():
    """The port's seeds and parameters are those of
    scripts/make_hard_fixture.py (read from its source)."""
    src = (REPO / "scripts/make_hard_fixture.py").read_text()
    assert "seed=5000 + i" in src and "seed=8000 + i" in src and "range(80)" in src
    assert "seed=3000 + i" in src and "seed=7000 + i" in src and "range(40)" in src
    assert fixtures.NANO_SEEDS["train"][0] == 5000 and len(fixtures.NANO_SEEDS["train"]) == 80
    assert fixtures.NANO_SEEDS["test"] == [8000 + i for i in range(6)]
    assert fixtures.FLAGSHIP_SEEDS == {"train": [3000 + i for i in range(40)],
                                       "test": [7000 + i for i in range(8)]}
