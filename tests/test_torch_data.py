"""The port's data pipeline (data/dsec.py, data/pipeline.py) against the
JAX package's on the same inputs.

The DSEC-shaped trees here are written by the JAX package's generator
(cv2 writes the frames), so the port's PNG reader is exercised on files it
did not write. Every comparison is exact: the index, labels and split are
the same numpy code, and a batch is the same bytes (the port decodes with
its own PNG reader, the JAX package with cv2). The split is also held to
scikit-learn's ``train_test_split``, which the JAX package calls.
"""

import threading
import time

import numpy as np
import pytest
from sklearn.model_selection import train_test_split

from snn_object_detectionddp_tpu import config as jconfig
from snn_object_detectionddp_tpu.data import dsec as jdsec
from snn_object_detectionddp_tpu.data import pipeline as jpipe
from snn_object_detectionddp_tpu.data.synthetic import TRACKS_DTYPE, make_dataset
from snn_object_detectionddp_tpu_torch import config as tconfig
from snn_object_detectionddp_tpu_torch.data import classes as tclasses
from snn_object_detectionddp_tpu_torch.data import dsec as tdsec
from snn_object_detectionddp_tpu_torch.data import pipeline as tpipe


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("dsec")
    # 4 sequences x 7 frames; 64x96; 3 classes
    make_dataset(root, num_sequences=4, num_frames=7, height=64, width=96)
    return root


def _cfgs(root, seq_len=3):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.Config()
        for split in ("train", "val", "test"):
            sc = cfg.dataset.split(split)
            sc.path = str(root / ("test" if split == "test" else "train"))
            sc.seq_len = seq_len
        cfg.model.max_boxes = 8
        out.append(cfg)
    return out


def _tracks(seed, n=40):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.randint(900, 9500, size=n)).astype(np.uint64)
    return np.array(
        [(t[i], *rng.uniform(-5, 90, 2), *rng.uniform(0, 30, 2), rng.randint(0, 8), 1.0, i)
         for i in range(n)],
        dtype=TRACKS_DTYPE,
    )


@pytest.mark.parametrize("seed", range(4))
def test_process_tracks_equal(seed):
    """Nearest-frame alignment, including detections before the first
    frame (dropped) and after the last (clipped to it)."""
    frame_ts = np.sort(np.random.RandomState(100 + seed).choice(np.arange(2000, 8000), 9,
                                                                 replace=False)).astype(np.int64)
    tracks = _tracks(seed)
    assert (tracks["t"] < frame_ts[0]).any() and (tracks["t"] > frame_ts[-1]).any()
    got, want = tdsec.process_tracks(tracks, frame_ts), jdsec.process_tracks(tracks, frame_ts)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == np.float32
    # Exactly the detections before the first frame are dropped.
    assert sum(len(v) for v in got.values()) == int((tracks["t"].astype(np.int64) >= frame_ts[0]).sum())


@pytest.mark.parametrize("seed", range(3))
def test_normalize_and_clip_equal(seed):
    rng = np.random.RandomState(seed)
    labels = np.concatenate([rng.randint(0, 8, (30, 1)), rng.uniform(-20, 120, (30, 2)),
                             rng.uniform(0, 40, (30, 2))], 1).astype(np.float32)
    labels[::7, 3] = 0.0  # zero-area rows
    got = tdsec.normalize_and_clip(labels, 64, 96)
    np.testing.assert_array_equal(got, jdsec.normalize_and_clip(labels, 64, 96))
    assert got.shape[0] < 30 and (got[:, 1:] >= 0).all() and (got[:, 1:] <= 1).all()
    empty = np.zeros((0, 5), np.float32)
    np.testing.assert_array_equal(tdsec.normalize_and_clip(empty, 64, 96),
                                  jdsec.normalize_and_clip(empty, 64, 96))


@pytest.mark.parametrize("n", [0, 3, 8, 11])
def test_pad_labels_equal(n):
    labels = np.random.RandomState(n).rand(n, 5).astype(np.float32)
    got, want = tpipe.pad_labels(labels, 8), jpipe.pad_labels(labels, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_dsec_index_equal(tree, mode):
    jcfg, tcfg = _cfgs(tree)
    j, t = jdsec.DSECIndex(jcfg, mode), tdsec.DSECIndex(tcfg, mode)
    assert len(t) == len(j) == 4 * (7 - 3 + 1)
    assert [tuple(vars(s).values()) for s in t.samples] == [tuple(vars(s).values()) for s in j.samples]
    assert [s.frame_paths for s in t.samples] == [s.frame_paths for s in j.samples]
    assert [s.last_frame_path for s in t.samples] == [s.last_frame_path for s in j.samples]
    # The test split has tracks.npy here, so it is labelled too.
    assert set(t.labels) == set(j.labels) and len(t.labels) == 4
    for i in range(len(t)):
        np.testing.assert_array_equal(t.sample_labels(i, 64, 96), j.sample_labels(i, 64, 96))


def test_invalid_mode_raises():
    with pytest.raises(ValueError, match="Invalid mode"):
        tdsec.DSECIndex(tconfig.Config(), "dev")


def test_split_matches_sklearn():
    """The seeded permutation draws scikit-learn's split for every n, in
    its order."""
    for n in range(2, 61):
        want_train, want_test = train_test_split(list(range(n)), test_size=0.2, random_state=42)
        got_train, got_test = tdsec.split_sequences(n)
        assert got_train.tolist() == want_train and got_test.tolist() == want_test, n
    assert tdsec.split_sequences(10, seed=7)[1].tolist() == train_test_split(
        list(range(10)), test_size=0.2, random_state=7)[1]


def test_split_of_one_sequence_raises_as_sklearn_does():
    with pytest.raises(ValueError):
        train_test_split(["seq_00"], test_size=0.2, random_state=42)
    with pytest.raises(ValueError, match="n_samples=1"):
        tdsec.split_sequences(1)


def test_train_val_split_and_debug_equal(tree):
    jcfg, tcfg = _cfgs(tree)
    j, t = jdsec.DSECIndex(jcfg, "train"), tdsec.DSECIndex(tcfg, "train")
    for seed in (42, 0, 3):
        assert tdsec.train_val_split(t, seed=seed) == jdsec.train_val_split(j, seed=seed)
    tr, va = tdsec.train_val_split(t)
    assert len(va) == 5 and sorted(tr + va) == list(range(len(t)))
    big = (list(range(150)), list(range(150, 190)))
    for on in (False, True):
        assert tdsec.apply_train_debug(*big, on) == jdsec.apply_train_debug(*big, on)
        assert tdsec.apply_test_debug(list(range(700)), on) == jdsec.apply_test_debug(
            list(range(700)), on)
    assert tdsec.apply_train_debug(*big, True) == (big[0][:100], big[1][:20])


def _batches(mod, cfg, mode, **kw):
    index = mod[0].DSECIndex(cfg, mode)
    loader = mod[1].BatchLoader(index, kw.pop("indices", list(range(len(index)))), **kw)
    return [list(loader) for _ in range(2)], len(loader)  # two epochs


@pytest.mark.parametrize(
    "mode,kw",
    [
        ("train", dict(batch_size=4)),
        ("train", dict(batch_size=3, shuffle=True, seed=5)),
        ("train", dict(batch_size=6, shuffle=True, drop_last=True)),
        ("val", dict(batch_size=7, indices=[19, 3, 4, 11, 0, 8, 2, 15, 9])),
        ("test", dict(batch_size=4, num_threads=1)),
    ],
    ids=["plain", "shuffle", "drop_last", "partial", "test_mode"],
)
def test_batch_loader_equal(tree, mode, kw):
    jcfg, tcfg = _cfgs(tree)
    opts = {"max_boxes": 8, "num_threads": 2, **kw}
    want, n_want = _batches((jdsec, jpipe), jcfg, mode, **dict(opts))
    got, n_got = _batches((tdsec, tpipe), tcfg, mode, **dict(opts))
    assert n_got == n_want and len(got[0]) == n_got
    for epoch_got, epoch_want in zip(got, want):
        assert len(epoch_got) == len(epoch_want)
        for bg, bw in zip(epoch_got, epoch_want):
            assert set(bg) == set(bw)
            assert bg["paths"] == bw["paths"]
            for k in set(bw) - {"paths"}:
                assert bg[k].dtype == bw[k].dtype and bg[k].shape == bw[k].shape, k
                assert bg[k].tobytes() == bw[k].tobytes(), k
    if kw.get("shuffle"):
        assert [b["paths"] for b in got[0]] != [b["paths"] for b in got[1]]  # per-epoch order
    if mode == "test":
        assert "labels" not in got[0][0]
    if "indices" in kw:  # 9 samples in batches of 7: the last holds 2 real rows
        last = got[0][-1]
        assert last["sample_mask"].tolist() == [True] * 2 + [False] * 5
        assert not last["label_mask"][2:].any()
        assert (last["images"][2:] == last["images"][1]).all()


def test_abandoned_iterator_joins_producer(tree):
    _, tcfg = _cfgs(tree)
    index = tdsec.DSECIndex(tcfg, "train")
    loader = tpipe.BatchLoader(index, list(range(len(index))), batch_size=2, num_threads=2,
                               prefetch=2)
    before = threading.active_count()
    for _ in range(3):
        it = iter(loader)
        next(it)
        it.close()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_transform_hook(tree):
    _, tcfg = _cfgs(tree)
    index = tdsec.DSECIndex(tcfg, "train")
    plain = next(iter(tpipe.BatchLoader(index, [0, 1], batch_size=2, max_boxes=4)))
    inverted = next(iter(tpipe.BatchLoader(index, [0, 1], batch_size=2, max_boxes=4,
                                           transform=lambda f: 255 - f)))
    np.testing.assert_array_equal(inverted["images"], 255 - plain["images"])
    np.testing.assert_array_equal(inverted["labels"], plain["labels"])


def test_decode_error_reaches_the_consumer(tree, tmp_path):
    import shutil

    root = tmp_path / "broken"
    shutil.copytree(tree / "train" / "seq_00", root / "seq_00")
    (root / "seq_00/images/left/distorted/000002.png").write_bytes(b"not a png")
    cfg = tconfig.Config()
    cfg.dataset.train.path, cfg.dataset.train.seq_len = str(root), 3
    index = tdsec.DSECIndex(cfg, "train")
    with pytest.raises(ValueError, match="000002.png"):
        list(tpipe.BatchLoader(index, list(range(len(index))), batch_size=2))


def test_classes_equal():
    from snn_object_detectionddp_tpu.data.classes import DSEC_DET_CLASSES

    assert tclasses.DSEC_DET_CLASSES == DSEC_DET_CLASSES
